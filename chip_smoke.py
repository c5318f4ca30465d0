#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pbr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of one frame per scene

Run from the root of a checkout. It builds the port's kernels from the
checkout's sources (one nvcc per source, all at once), then drives the
port's paths through the entry points a user calls, at full size, with
bench.py's settings (1024², 1 sample per pixel, 8 bounces, NEE,
Shirley-Ashikhmin, compaction and lane order from the occupancy probes).
Each path runs with the kernels' launch counts set to 0 just before it and
read just after; a kernel of the path that did not launch fails the run.
A frame of ``PathTracer`` is a replay of a CUDA graph: its launches are
the graph's kernel nodes of the port's kernels, read from the driver at
the capture, once a replay (``ops.counts``); phase 11 holds them to an
eager frame's launches and to what the device ran (torch.profiler).

1. device: a CUDA card of compute capability 9.0, its name and power limit;
2. build: K1/K2 (csrc/brute_intersect.cu), K3 (csrc/gated_intersect.cu),
   K4/K4m (csrc/cull_intersect.cu), K5/K5m (csrc/row_sweep.cu), K6/K7
   (csrc/bvh_packet.cu), K8 (csrc/bvh_walk.cu), K9 (csrc/phong_walk.cu),
   K10 (csrc/phong_clusters.cu), K11/K12 (csrc/shade.cu), their backward,
   K11 bwd and K12 bwd (csrc/shade_bwd.cu), and compaction's K13/K14 with
   their backward (csrc/compact.cu) with nvcc, and the native BVH builder
   (csrc/bvh_builder.cpp) with g++, all in parallel, timed. Every forward frame on the card shades in
   K11 (camera rays, once a sample) and K12 (once a bounce, or "K12 pre"
   and "K12 post" where the shadow leg is a walk of its own), and the
   backward of a frame that autograd records runs K12 bwd once a bounce
   and, where the camera requires grad, K11 bwd once a sample; a frame
   with a compaction schedule gathers each stage's rows by K13 and folds
   them back by K14, once a stage each, and its backward runs K13 bwd and
   K14 bwd as often; the launch checks of the search kernels below leave
   them out and print the shading's, and the paths, the shade and the
   graph phases hold their counts;
3. Cornell box (34 faces; auto runs K1):
   - K1 and K2 (NEE, and K1', K2' nearest only) against their plain
     versions on the card, bitwise (t, face, occluded), on the path's
     camera rays, a ragged random batch, a 4,000-face soup, soups of 1,
     255, 256, 257, 511, 512 and 513 faces (on both sides of the kernels'
     256-face staged chunk and of twice it) and a scene whose every
     shadow ray is occluded by face 0, with more than a chunk of faces
     after it; K1's faces also against the plain sweep on the host's CPU;
   - a 128² frame on the card against the port's CPU path: no NaN and at
     least 99% of pixels within 1e-3 (the CPU tests hold the CPU path to
     the JAX package's NumPy oracle);
   - path "cornell": the first 1024² frame, compacted, equals bitwise the
     same frame at full width; then 8 timed frames after 2 warm-up frames
     (K1 launches once a bounce, 0 lanes dropped, a plausible image); K1
     and K1' timed on the camera rays as 20 calls replayed from a CUDA
     graph (the kernel is shorter than the wrapper's host time), with
     their bounds;
   - path "cornell, NEE off" (shadow_rays=0): one frame through K1'
     (nearest only);
4. multiroom (bench.py --scene multiroom: 1,428 faces in 32 clusters of 64;
   auto runs K3 over the cull verdicts of ops/cull.py):
   - a 128² frame on the card against the port's CPU path (the gated
     sweep's plain version), at least 99% of pixels within 1e-3;
   - path "multiroom": the first 1024² frame, compacted, equals bitwise
     the full-width frame; the auto frame against the same frame through
     K1 (intersector='pallas', whose launches are counted: 8, and no
     other kernel) at least 99% of pixels within 1e-3 (the two use
     different Moller-Trumbore forms); 8 timed frames after 2 warm-up
     frames, in which K3 launches and K1 does not, 0 lanes dropped;
   - K3 (nearest and any-hit passes) and K2 (NEE and nearest) against
     their plain versions, bitwise, on the path's 1024² camera rays (in its
     lane order), on 1M bounce-like rays with 60% alive and NEE, and on 1M
     bounce-like rays with 15% alive, whose shadow pass is mostly seeded 1
     or occluded (K3's exits), with K3's executed test counts equal; K3's
     faces against K2's on live lanes; K1 (NEE and nearest) against its
     plain version, bitwise, on the camera rays; times per call of K3, K2
     and K1 and of their plain versions, the bounds charging t to every
     test and u and v only where t can change the result (K3:
     tools/k3_tiles.py::pass_counts over its gated-in real faces; K1 and
     K2: tools/k1_sweep.py::sweep_counts over all faces, the shadow leg up
     to each ray's first occluder);
   - path "multiroom, forward+backward": bench.py's step (loss = sum of
     the frame's colors; gradients to every material and light parameter
     and to the eye) at 1024², timed, with its peak memory and finite
     gradients, K11, K12, K11 bwd and K12 bwd launching once a sample or a
     bounce of each step; at 64², the card's gradients against the CPU's
     (the plain adjoints);
   - path "linear form": K2's entry point (intersect_fused(variant='lin'),
     which no render mode selects, as in the JAX package) on the path's
     camera rays, NEE and nearest;
   - path "multiroom, cull" (intersector='cull': 32 clusters, so K4m, the
     masked cull-and-sweep): one 1024² frame in which K4m launches once a
     pass and bounce and no other kernel, within 1e-3 of the auto (K3)
     frame on at least 99% of pixels; K4m against its plain version,
     bitwise, on the path's camera rays and on 1M bounce-like rays with
     60% alive, timed on the camera rays, with its bound (t for every
     real-face test, u and v only where t can change the result:
     tools/k4_tiles.py::pass_counts, as K4's);
   - path "multiroom, sweep" (intersector='sweep': 16 lin clusters of 128,
     so K5m, the masked row sweep): one 1024² frame in which K5m launches
     once a pass and bounce and no other kernel, within 1e-3 of the auto
     (K3) frame on at least 99% of pixels; K5m (nearest and any-hit)
     against its plain version, bitwise, on the path's camera rays and on
     1M bounce-like rays with an alive mask, timed, with its bound, and
     from the copy with a record a block (tools/k5_rows.py) its active rows
     a staged table, staging share, span and tail;
   - the device golden of the bands the card's table moved
     (docs/BAND_TABLE_H100.json; ``auto_golden_phase``) on soup:1025 (now
     K1's band) and multiroom:6,6,30 (14,460 faces, now K8's): the first
     1024² auto frame, compacted, equals bitwise the full-width frame and
     is within 1e-3 of the same frame through K1 (intersector='pallas', 8
     K1 launches and no other kernel) on at least 99% of pixels, no NaN;
     one auto frame launches the table's pick (``AUTO_PICKS``) once a
     bounce and nothing else; at 64², the card's gradients through auto
     against those through K1 (every parameter within 1e-3 of its largest
     magnitude over the pixels whose colors agree); on soup:1025 auto is K1
     itself, so only the launch check tells there;
5. soup:100000 (bench.py --scene soup:100000: 100,000 faces, 784 clusters of
   128 in 49 superclusters; auto runs K8, the per-ray walk, on its BVH of
   64-face leaves):
   - a 64² frame on the card against the port's CPU path, at least 99% of
     pixels within 1e-3;
   - path "soup:100000": the device golden, as above (auto launches K8
     and K8 any-hit);
   - path "soup:100000 cull" (intersector='cull': K4 over the candidate
     lists of ops/cull.py, with the coherence sort and the early-out): the
     first 1024² frame, compacted, equals bitwise the full-width frame and
     is within 1e-3 of the auto frame on at least 99% of pixels; 8 timed
     frames after 2 warm-up frames, in which K4's nearest and any-hit
     instances launch once a bounce each and nothing else, 0 lanes
     dropped;
   - K4 (nearest and any-hit) against its plain version, bitwise, on all
     the path's 1024² camera rays (in its lane order) and on 1M bounce-like
     rays with an alive mask and NEE; the candidate-slot share per tile and
     the executed slots a tile (max, mean, the top 1% of tiles' share);
     times per call of K4's passes, of the whole wrapper and of its plain
     version; K1 (NEE) on the camera rays against its plain version,
     bitwise (one call, timed), its time and its bound;
   - path "soup:100000, sweep" (bench.py --scene soup:100000 --intersector
     sweep: 784 lin clusters of 128, so K5, the slotted row sweep, with the
     coherence sort and the row early-out): a 64² card frame against the
     CPU frame of the tree phase below; the first 1024² frame, compacted,
     equals bitwise the full-width frame and is within 1e-3 of the 'cull'
     (K4) frame on at least 99% of pixels; 8 timed frames in which K5's
     nearest and any-hit instances launch once a bounce each and nothing
     else, 0 lanes dropped, with the frame's test counter; K5 against its
     plain version, bitwise (with the counters), on all 1M camera rays and
     on 1M bounce-like rays with an alive mask and NEE (its tiles
     heaviest first, on the face-major lin table); the executed share of
     (row, slot) pairs, and from a copy of K5 with a record a block
     (tools/k5_rows.py) the active rows a staged slot and the staging
     share of a block's time; times per call of K5's passes, of the
     wrapper and of its plain version, with the bound;
6. the tree walks on soup:100000 (4,523 nodes, 64-face leaves, and a forest
   from accel.forest.build_forest: 13 sub-trees of 8,192 faces) and on
   soup:10000 (bench.py --scene soup:10000: 11,953 nodes, 2-face leaves):
   - 64² card frames through 'pallas_bvh_hbm' (K7), 'bvh' (K8),
     'pallas_bvh_forest' (K6's chain) and 'sweep' (K5) against one CPU
     frame through 'bvh' (the three walks' plain versions are one function;
     every intersector returns the same faces), at least 99% of pixels
     within 1e-3;
   - path "soup:100000, pallas_bvh_hbm": the first 1024² frame, compacted,
     equals bitwise the full-width frame and is within 1e-3 of the 'cull'
     (K4) frame on at least 99% of pixels; 8 timed frames in which K7 NEE
     launches once a bounce and nothing else launches, 0 lanes dropped;
     one frame with NEE off through K7's nearest instance;
   - path "soup:100000, bvh": the same checks, 8 timed frames with K8's
     two instances launching once a bounce each (the nearest walk, and
     the any-hit shadow walk on the lanes that cast a shadow ray), and the
     frame's ray-face tests and node visits (with_stats); then one more
     frame's shadow walks, recorded, each replayed bitwise against the
     plain version and held to the form it replaces (the nearest walk on
     every lane of the bounce, then t < t_light) on every casting lane,
     with both forms' times;
   - path "soup:100000, forest": the first-frame checks and one frame of
     K6's chain (nearest and any-hit on sub-tree 0, then the seeded chain
     over sub-trees 1-12 in one launch a pass);
   - path "soup:10000, pallas_bvh": one 1024² frame through K6 with NEE
     against its auto (K3) frame;
   - every instance of K6, K7 and K8 against its plain version, bitwise,
     on all the 1024² camera rays of its path (K7 and K8's two instances
     and the forest's chain, against the plain chain of one walk a
     sub-tree, also on 1M bounce-like rays with an alive mask; K8 also
     against intersect_bvh_chunked), with its kernel time, plain time and
     bound (the per-ray walk's node steps x 25 operations, its face tests
     x 35 for t and x 16 more for u and v only where t can change the
     result, as K1's, against the tables' and rays' bytes; one bound for
     the seeded chain's sub-trees together; the bound with the whole test,
     51, on every face beside it);
7. the app layer (``pbr_tpu_torch.app``, run in-process as ``app.main``
   on the card; its files under build/pbr_tpu_torch/app/):
   - ``render`` on the Cornell box at 1024², FRAMES frames with --stats
     --heatmap --depth-out --checkpoint: K1 launches once a bounce of each
     frame, of the first frame's two lane-order probes and of the heatmap's
     trace, and nothing else launches; the three PNGs have the frame's
     size; the image equals PathTracer's frames of the same seeds
     (bitwise, else the frame gate); ms/frame; then one resumed frame with
     --denoise (sample_count FRAMES + 1, the feature pass one K1' launch)
     and its denoise ms; then ``render --scene multiroom`` (K3 only);
   - the denoiser (first_hit_features + noise_filter) at 128² on the card
     against the port's CPU path, the frame gate;
   - ``fit`` on the Cornell box at 64², 60 steps: final loss at most a
     quarter of the first, max albedo error at most 0.1, no step raising
     the loss, ms/step; ``fit --scene multiroom`` at 1024², STEPS steps
     (K3 and K3 any-hit), ms/step and peak memory;
   - the ``gemm`` mode on the Cornell box's 1M camera rays against K1'
     (faces agree on more than 99.5% of rays, t within 1e-4 where they
     do), ms per call beside K1''s, its chunk and peak memory; a 1024²
     frame through it (no kernel of the port launches) against the K1
     frame, the frame gate;
   - ``view`` at 256² with the keys 'wasdl' over 6 frames: 4 restarts,
     sample_count 3, light mode on, K1 once a bounce of each frame, of
     the two probes and of the eager frame of the tracer's ``warmup``
     (its capture, undone).
   The app's numbers are one JSON line {"app": ...} before the kernels'
   line.
8. Phong tessellation (``ops/phongtess.py``; its searches are kernels K10,
   the cluster search, and K9, the Phong BVH walk, ``ops/cuda_phong.py``):
   the Cornell box and a smooth 24 x 12 sphere (562 faces, 9 clusters of 64
   over the curved-patch-inflated bounds) at alpha 0.8 with bench.py's
   settings: a 64² card frame against the port's CPU frame (at least 99%
   of pixels within 1e-3, no NaN); the 64² card gradients against the
   CPU's (the CPU's passes of 4,096 rays by the plain cluster search,
   PHONG_OLD_MIN_RAYS, about a third of the plain walk's time); the first
   1024² frame, compacted, bitwise the full-width frame; the frame step's
   graph holding the search of the card's Phong band
   for each pass (``phongtess.CLUSTER_MIN_RAYS``, docs/PHONG_BANDS_H100.json:
   K10 from that many rays, K9 below, its any-hit instance for the shadow
   legs; None: K9 for every nearest pass and K9 any-hit for every shadow
   leg; an eager frame's searches, recorded) and no other kernel of the
   port;
   PHONG_FRAMES replayed frames, timed, each bitwise the eager frame,
   which is timed too, with the launches over the replays, one replay
   under the profiler (launches and device time a frame) and the peak
   memory; K9 against its plain version on the card, bitwise (t, face, u,
   v), on 4,095 camera rays, on all 1M camera rays and on 1M rays in the
   box (each in its pass kind's launch order, with K9's registers); K9
   any-hit against its plain version, bitwise, and against the nearest
   search's t < t_limit on the card (any ray that differs raises), on the
   frame's recorded shadow rays of bounces 0 and 1 and on the 1M box rays
   with t_limit drawn around each ray's nearest t; and K10 (face, u, v
   and each tile's rounds, on the rays in its tile order, and on the rays
   as given) on the 1M camera rays and the 1M
   rays in the box, each with its kernel, wrapper and plain times and its
   bounds (K10: the tests it runs, and the yardstick, the JAX loop's
   rule's tests); the Phong device golden: the 1024² frame and the 64²
   gradients under the band's
   threshold against those under the JAX package's (K10 from
   PHONG_OLD_MIN_RAYS = 4,096 rays), at least 99% of pixels within 1e-3
   and every gradient within 1e-3, the old threshold's frames counting
   K10's launches and its replayed frame bitwise its eager frame;
   ``fit``'s graphed steps on the scene at 64² (the band's kernel for
   4,096-ray passes) bitwise the eager step; the first frame
   against the same scene built and rendered flat (alpha 0: K1), which
   must differ; then the 1024² frames and the kernel checks again on a
   denser sphere (PHONG_DENSE: 9,058 faces, 142 clusters). The phase's
   seconds are printed;
9. sharding (``pbr_tpu_torch.parallel``): 2 ranks spawned on the one card
   over gloo (NCCL refuses two ranks on one device): Cornell at 1024² as
   dp=2 (bitwise the unsharded frame) and sp=2 (within 1e-6 of the mean
   of the two shard seeds' frames), and one dp=2 training step (loss and
   gradients within 1e-4 of their largest magnitude of one process's);
   then a one-rank NCCL group through sharded_render (bitwise the
   unsharded frame). Every spawn is joined under SHARD_TIMEOUT. The ranks'
   times show that the code runs on the card, not how it scales.
   The Phong and sharded numbers are one JSON line {"phong": ...,
   "sharded": ...} before the kernels' line.
10. the bench (``pbr_tpu_torch/bench.py``): first its backward step
   (``bench.step_grads``: the gradients to every material, light and
   camera parameter) on the Cornell box (K1) and soup:100000 (K8, K8
   any-hit) at 64², 2 frames, the card's against the CPU's over the
   pixels whose colours agree: the loss within 1e-4 and every parameter
   within 1e-3 of its largest magnitude. Then the entry point
   (``python -m pbr_tpu_torch.bench``), run from
   the checkout's root in a subprocess each, as the benchmark runs it:
   ``--iters 3`` (Cornell, forward+backward, 1024², the default 32
   frames a step) and ``--scene soup:100000 --fwd-only --iters 3
   --frames-per-step 4``. Each exits 0 and its last line has exactly
   bench.py's keys, unit rays/s and a finite positive value; its log shows
   the frame step's capture; its launch line shows K1 alone on the Cornell
   box and K8 with K8 any-hit on soup:100000, once a bounce of each frame
   of each timed step (a replay of the frame's graph); its rays a frame equal
   those of this script's own path of the scene (paths "cornell" and
   "soup:100000, bvh") at seed 0. The phase's time is printed, and its
   results are one JSON line {"bench": ...} before the kernels' line.
11. CUDA graphs (``pbr_tpu_torch/utils/graph.py``), before the bench: a
   step that reads the host raises before its capture, naming the line;
   the captured frame step of ``PathTracer`` on every band of ``auto``
   (Cornell: K1; multiroom: K3; soup:100000: K8; the band table's
   soup:10001 without clusters: K8) and every explicit mode that the
   card serves ('pallas' K1, 'cull' K4m and 'sweep' K5m and 'gemm' on
   multiroom; 'cull' K4, 'sweep' K5, 'pallas_bvh_hbm' K7 and
   'pallas_bvh_forest' K6's chain on soup:100000; 'pallas_bvh' K6 NEE on
   soup:10000), at 1024²: ``warmup`` captures it (seconds, graph nodes,
   pool bytes); 4 replayed frames with a camera move after the second,
   each bitwise (accumulator, depth and count) the eager ``render_frame``
   frame; the graph's kernel nodes of the port's kernels (read from the
   driver, ``CapturedStep.kernels``) those of an eager frame, the path's
   kernels once a bounce, and the port's kernels that the device ran over
   2 bare replays (torch.profiler) twice those; eager and graphed
   ms/frame in two interleaved rounds (one for an explicit mode). Then
   the bench's graphed step
   (``tools/graph_steps.py::measure``: ``bench.FrameStep``, 2 frames) on
   Cornell (K1) and soup:100000 (K8) at 1024², forward and backward,
   bitwise ``bench.step`` and ``bench.step_grads`` (the loss and all 28
   gradients), the eager step's launches and the device's over 2 bare
   replays twice the graph's port kernel nodes, each timed eager and
   graphed; and
   ``fit``'s graphed steps
   (``app.fit_steps``) on Cornell at 64² and multiroom at 1024², bitwise
   the eager step at three points. Every other phase's ``PathTracer``
   frames are replays too: frame 0 of a tracer is the capture's eager run.
   The phase's results are one JSON line {"graph": ...}.

12. shading (``ops/cuda_shade.py``, ``shade_phase``, after the tree
   walks): on 1024² eager frames of Cornell (SA and Schlick, NEE on and
   off, a glass material with transparency on), multiroom (K3, fused),
   soup:100000 (K8: pre and post, the orb light) and the Phong sphere (K9
   any-hit: pre and post, curved normals), every K11 and K12 call recorded
   and held bitwise to its plain version (as bit patterns: a NaN counts;
   a difference names the output, its lanes and its largest ULP); on the
   backward step (bench.py's: every material, light and camera parameter)
   of each case, the sphere's curved normals too, every K11 bwd and K12
   bwd call recorded and held to its plain adjoint (``shade_vjp_terms``,
   ``gen_rays_vjp_terms``): each lane's gradients bitwise, the table's
   and the camera's sums within 1e-5 of the float64 sum of their terms'
   absolute values; Cornell's bounce 0 again over 600 materials, whose
   warp rows do not fit in shared memory (the scratch rows in global
   memory), the same way; the frames of Cornell, multiroom, soup:100000
   and the Phong sphere through the kernels bitwise the same frames
   through the plain versions (the integrator's two wrappers swapped for
   them, ``_plain_shading``: no shading kernel launches) and the frames
   autograd records, whose forward and backward launch K11, K12, K11 bwd
   and K12 bwd; K11, K12, K12 pre and K12
   post each timed alone on its main path's bounce 0, and K11 bwd and K12
   bwd on Cornell's backward step's (20 launches from a CUDA graph),
   against its plain version, with its bound (bytes in once and out
   once); on the backward steps of Cornell and the Phong sphere, every
   K13, K13 bwd, K14 and K14 bwd call (each stage's, ``compact_phase``)
   recorded and held bitwise to its plain version, each instance timed on
   Cornell's first stage, each launch after a read that flushes the L2
   cache (and warm, 20 in a row), against its plain version and one
   PyTorch call a field (``index_select`` for K13 and K14 bwd, ``index_put`` with
   accumulate, the old gathers' backward, for K13 bwd and K14), with its
   bound. The graph phase holds each forward frame's graph to K11 once a
   sample and K12 once a bounce (or pre and post once each), and the
   bench's forward+backward graphs to those and K11 bwd once a sample and
   K12 bwd once a bounce.

Every failure raises, so the exit code is not 0. The last two lines of
standard output are the kernels' JSON record (with each kernel's bound: the
larger of its operations over 67 T op/s float32 and its bytes over
3.35 TB/s, the H100's published peaks; ``launches`` counts the launches
over ``frames`` frames of its path; "K1 (multiroom)" and "K1
(soup:100000)" are K1 at those scenes' face counts, launched by their
intersector='pallas' frames; K9's and K10's times are on the Phong path's
1M camera rays; K11's and K12's on Cornell's bounce 0, K12 pre's and
post's on soup:100000's (their launches: Cornell's timed frames and the
'bvh' path's), K11 bwd's and K12 bwd's on Cornell's backward step's
bounce 0 (their launches: the multiroom forward+backward path's STEPS
steps); K13's, K14's and their backward's on Cornell's backward step's
first stage (their launches: Cornell's timed frames, K13 and K14, and
the multiroom forward+backward path's, K13 bwd and K14 bwd), with
``library_ms``; K10's row adds the yardstick bound ``bound_jax_ms``
beside ``bound_ms``, the bound of the tests it runs, and its launches over
the Phong golden's frames under the JAX package's threshold,
``golden_launches`` over ``golden_frames``: its ``launches`` are the main
path's, 0 under a band that sends every pass to K9) and ``{"ok": true,
"device": {...}}``. The script needs nothing of JAX: any import of it, or of the JAX
package, fails (``sys.modules``); scenes are built by the port's own host
layer.
"""

import sys

sys.modules["jax"] = None  # the port must run where JAX is absent ...
sys.modules["pbr_tpu"] = None  # ... and imports nothing of the JAX package

import contextlib  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pbr_tpu_torch import PathTracer, app, camera_to_torch, to_torch, trace_rays  # noqa: E402
from pbr_tpu_torch.accel import native  # noqa: E402
from pbr_tpu_torch.accel.forest import build_forest  # noqa: E402
from pbr_tpu_torch import bench  # noqa: E402
from pbr_tpu_torch.bench import bench_settings, card_line, load_scene  # noqa: E402
from pbr_tpu_torch.models.pathtracer import (  # noqa: E402
    FrameState,
    init_frame_state,
    render_frame,
)
from pbr_tpu_torch.ops import counts, kernel_counts, zero_counts  # noqa: E402
from pbr_tpu_torch.ops import cuda_bvh as cb  # noqa: E402
from pbr_tpu_torch.ops import cuda_compact as ccp  # noqa: E402
from pbr_tpu_torch.ops import cuda_cull as cc  # noqa: E402
from pbr_tpu_torch.ops import cuda_gated as cg  # noqa: E402
from pbr_tpu_torch.ops import cuda_intersect as ci  # noqa: E402
from pbr_tpu_torch.ops import cuda_phong as cp  # noqa: E402
from pbr_tpu_torch.ops import cuda_shade as csh  # noqa: E402
from pbr_tpu_torch.ops import cuda_sweep as cs  # noqa: E402
from pbr_tpu_torch.ops.cuda_shade import gen_rays  # noqa: E402
from pbr_tpu_torch.ops import gemm_intersect as gi  # noqa: E402
from pbr_tpu_torch.ops import phongtess  # noqa: E402
from pbr_tpu_torch.ops import traverse as tt  # noqa: E402
from pbr_tpu_torch.ops.denoise import first_hit_features, noise_filter  # noqa: E402
from pbr_tpu_torch.ops.intersect import EPS5  # noqa: E402
from pbr_tpu_torch.ops.rng import PixelRng, fold  # noqa: E402
from pbr_tpu_torch.ops.vec import Vec3  # noqa: E402
from pbr_tpu_torch.parallel.mesh import (  # noqa: E402
    _shard_seed,
    leaf_camera,
    make_mesh,
    render_params,
    sharded_render,
    sharded_train_step,
)
from pbr_tpu_torch.parallel.multihost import shard_index_map, spawn_ranks  # noqa: E402
from pbr_tpu_torch.scene.build import apply_scene_constants, scene_from_text  # noqa: E402
from pbr_tpu_torch.scene.camera import make_camera_state  # noqa: E402
from pbr_tpu_torch.scene.device import ForestTables  # noqa: E402
from pbr_tpu_torch.scene.procedural import (  # noqa: E402
    cornell_box,
    cornell_sphere,
    grey_soup,
    multi_room,
    random_soup,
)
from pbr_tpu_torch.scene.types import TrianglesSoA  # noqa: E402
from pbr_tpu_torch.tools import graph_steps, k1_sweep, k3_tiles, k4_tiles, k5_rows  # noqa: E402
from pbr_tpu_torch.utils.config import BRDF_SCHLICK, RenderSettings  # noqa: E402
from pbr_tpu_torch.utils.graph import CapturedStep  # noqa: E402
from pbr_tpu_torch.utils.image import read_png  # noqa: E402

SIZE = 1024
WARMUP, FRAMES, STEPS = 2, 8, 3
BOUNCE_RAYS = 1 << 20
K12_SOURCE = "pbr_tpu_torch/csrc/brute_intersect.cu"
K3_SOURCE = "pbr_tpu_torch/csrc/gated_intersect.cu"
K4_SOURCE = "pbr_tpu_torch/csrc/cull_intersect.cu"
K5_SOURCE = "pbr_tpu_torch/csrc/row_sweep.cu"
K67_SOURCE = "pbr_tpu_torch/csrc/bvh_packet.cu"
K8_SOURCE = "pbr_tpu_torch/csrc/bvh_walk.cu"
K9_SOURCE = "pbr_tpu_torch/csrc/phong_walk.cu"
K10_SOURCE = "pbr_tpu_torch/csrc/phong_clusters.cu"
# The H100's published peaks (SXM, at its 700 W limit): float32 outside the
# tensor cores, and device memory. --fmad=false halves the issue ceiling
# the kernels can reach (33.5 T op/s), which the bound does not assume.
PEAK_OPS, PEAK_BYTES = 67e12, 3.35e12
# Floating-point operations of one ray-face test, as the function needs
# them. Classic Moller-Trumbore (K1): p = d x e2 9, det 5, 1/det 1,
# o - v0 3, q = (o - v0) x e1 9, t, u, v 6 each, the gates 5, the minimum
# 1: 51 (OPS_CLASSIC, printed beside the walks' bounds), which the bounds split:
# every test needs t (p, det, 1/det, o - v0, q, t 6, the gate t >= 1e-5 and
# the comparison with the ray's bound 2: 35), and only a face whose t can
# change the result needs u and v (6 each, their gates 4: 16). Linear form
# (K2, K3, K5, K5m; K4 and K4m read its nonzero entries from a compact
# table): det 5, 1/det 1, t 7, u 12, v 13, the gates 5, the minimum 1: 44,
# split the same way: t (det, 1/det, t, the two gates: 15), u and v (u 12,
# v 13, their gates 4: 29). The bound counts what the function needs,
# whatever implements it.
OPS_CLASSIC = 51
OPS_CLASSIC_T, OPS_CLASSIC_UV = 35, 16
OPS_LIN_T, OPS_LIN_UV = 15, 29
# Floating-point operations of one ray-box slab test, as the tree walks
# need them: (bound - o) * inv for 6 bounds 12, a min and a max per axis 6,
# t_near and t_far 4, the gates t_near <= t_far, t_far > EPSILON5 and
# t_best > t_near 3.
OPS_SLAB = 25
# What ``auto`` launches a bounce on each scene of the device golden
# (``auto_golden_phase``), by the card's band table (docs/BAND_TABLE_H100.json).
AUTO_PICKS = {
    "soup:1025": ("K1",),  # K1's band, moved up from 1,024 faces
    "multiroom:6,6,30": ("K8", "K8 any-hit"),  # K8's band, K4's before: 14,460 faces
    "soup:100000": ("K8", "K8 any-hit"),
}
# The TPU kernel each instance replaces (pbr_tpu/ops/...: the body's line).
REPLACES = {
    "K1": "pbr_tpu/ops/pallas_intersect.py:182",  # _kernel_nee around _sweep
    "K1'": "pbr_tpu/ops/pallas_intersect.py:167",  # _kernel around _sweep
    "K2": "pbr_tpu/ops/pallas_intersect.py:99",  # _sweep_lin in _kernel_nee
    "K2'": "pbr_tpu/ops/pallas_intersect.py:99",  # _sweep_lin in _kernel
    "K3": "pbr_tpu/ops/pallas_gated.py:73",  # _kernel, nearest and any-hit
    "K4": "pbr_tpu/ops/pallas_cull.py:89",  # _kernel (slotted), nearest and any-hit
    "K4m": "pbr_tpu/ops/pallas_cull.py:183",  # _kernel_masked, nearest and any-hit
    "K5": "pbr_tpu/ops/pallas_sweep.py:153",  # _kernel_rows, nearest and any-hit
    "K5m": "pbr_tpu/ops/pallas_sweep.py:204",  # _kernel_masked_rows, nearest and any-hit
    "K6 nearest": "pbr_tpu/ops/pallas_bvh.py:181",  # _kernel around _traverse_tile
    "K6 NEE": "pbr_tpu/ops/pallas_bvh.py:197",  # _kernel_nee
    "K6 any-hit": "pbr_tpu/ops/pallas_bvh.py:248",  # _kernel_shadow
    "K6 seeded": "pbr_tpu/ops/pallas_bvh.py:263",  # _kernel_seeded
    "K6 seeded any-hit": "pbr_tpu/ops/pallas_bvh.py:276",  # _kernel_shadow_seeded
    "K7 nearest": "pbr_tpu/ops/pallas_bvh.py:589",  # _kernel_hbm around _traverse_tile_hbm
    "K7 NEE": "pbr_tpu/ops/pallas_bvh.py:600",  # _kernel_hbm_nee
    "K8": "pbr_tpu/ops/traverse.py:276",  # the XLA while_loop body of intersect_bvh
    "K8 any-hit": "pbr_tpu/models/integrator.py:352",  # its shadow leg: t_sh < t_light
    "K9": "pbr_tpu/ops/phongtess.py:458",  # the XLA while_loop of intersect_bvh_phongtess
    "K9 any-hit": "pbr_tpu/models/integrator.py:339",  # its Phong shadow leg: t_sh < t_light
    "K10": "pbr_tpu/ops/phongtess.py:730",  # the XLA while_loop of intersect_clusters_phongtess
    "K11": "pbr_tpu/models/integrator.py:287",  # no Pallas kernel: XLA's fusion of _gen_rays
    "K12": "pbr_tpu/models/integrator.py:579",  # no Pallas kernel: XLA's fusion of the shade
    "K11 bwd": "pbr_tpu/models/integrator.py:287",  # XLA's fusion of jax.grad of _gen_rays
    "K12 bwd": "pbr_tpu/models/integrator.py:579",  # XLA's fusion of jax.grad of the shade
    "K13": "pbr_tpu/models/integrator.py:863",  # no Pallas kernel: XLA's stage row gathers
    "K13 bwd": "pbr_tpu/models/integrator.py:863",  # their transposes under jax.grad
    "K14": "pbr_tpu/models/integrator.py:905",  # no Pallas kernel: XLA's gathers of the fold
    "K14 bwd": "pbr_tpu/models/integrator.py:905",  # their transposes under jax.grad
}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def cornell():
    """The bench's Cornell box and camera (``bench.load_scene``)."""
    return load_scene("cornell")[:2]


def multiroom():
    """The bench's --scene multiroom (``bench.load_scene``)."""
    scene, cam = load_scene("multiroom")[:2]
    if scene.clusters is None or scene.clusters.size != 64:
        raise AssertionError("multiroom must carry a ClusterSet of 64-face clusters")
    return scene, cam


def soup():
    """The bench's --scene soup:100000 (``bench.load_scene``), built by the
    port's host layer (the native BVH builder) and timed."""
    t0 = time.perf_counter()
    scene, cam = load_scene("soup:100000")[:2]
    sec = time.perf_counter() - t0
    cs = scene.clusters
    if cs is None or cs.size != 128:
        raise AssertionError("soup:100000 must carry a ClusterSet of 128-face clusters")
    phase("soup:100000", f"scene built in {sec:.3f} s: {scene.tris.count} faces, "
                         f"{cs.coeffs.shape[0]} clusters of {cs.size} in "
                         f"{cs.sup_min.x.shape[0]} superclusters, coefficient table "
                         f"{tuple(cs.coeffs.shape)} ({cs.coeffs.nbytes / 2**20:.1f} MiB)")
    return scene, cam


def _bound(ops: float, nbytes: float) -> tuple:
    """The least time the card could take for work of ``ops`` float32
    operations and ``nbytes`` moved, in ms, and which of the two bounds
    it."""
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0 (Hopper), got {cap}")
    smi = card_line()
    print(smi, flush=True)
    phase("device", f"{torch.cuda.get_device_name(0)}, capability {cap}, torch "
                    f"{torch.__version__}, CUDA {torch.version.cuda}")
    return smi


def _build_native():
    """The native BVH builder, compiled with g++; raises where it does not
    build (the host layer would fall back to its NumPy builder)."""
    if native.load_library(rebuild=True) is None:
        raise RuntimeError("the native BVH builder (csrc/bvh_builder.cpp) did not build")
    return Path(native._LIB)


# The row sweep (K5, K5m) as built and its copy with a record a block
# (tools/k5_rows.py), built with the kernels: {record: (library, ptxas report)}.
K5_RECORD = {}


def build_phase() -> None:
    """One nvcc per kernel source and one g++, all started together, and
    the row sweep's two diagnostic copies."""
    def timed(name):
        t0 = time.perf_counter()
        if name == "k5 record":
            K5_RECORD.update(k5_rows.build())
            return name, time.perf_counter() - t0, "build/pbr_tpu_torch/diag/"
        path = _build_native() if name == "bvh_builder" else ci.build(name)
        return name, time.perf_counter() - t0, path.name

    t0 = time.perf_counter()
    names = ("brute_intersect", "gated_intersect", "cull_intersect", "row_sweep", "bvh_packet",
             "bvh_walk", "phong_walk", "phong_clusters", "shade", "shade_bwd", "compact",
             "bvh_builder", "k5 record")
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        done = list(pool.map(timed, names))
    for name, sec, lib in done:
        phase("build", f"{name} built in {sec:.3f} s -> {lib}")
    phase("build", f"all kernels built in {time.perf_counter() - t0:.3f} s")


def _to_dev(a: np.ndarray, dev) -> Vec3:
    return Vec3(*(torch.tensor(c, device=dev) for c in a))


def _rays_in_box(n: int, seed: int, dev) -> tuple:
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.8, 0.8, (3, n)).astype(np.float32)
    o[1] += 1.0
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return _to_dev(o, dev), _to_dev(d, dev)


def _rays_in_rooms(n: int, seed: int, dev) -> tuple:
    """Bounce-like rays in multiroom: origins inside the rooms, random unit
    directions."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-2.9, 2.9, n), rng.uniform(0.05, 1.95, n),
                  rng.uniform(-4.9, 0.9, n)]).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return _to_dev(o, dev), _to_dev(d, dev)


def _camera_rays(cam_t, settings: RenderSettings, dev, ids=None) -> tuple:
    """A path's first-bounce rays: all pixels of frame 0, in lane order
    ``ids`` (scanline when None)."""
    if ids is None:
        ids = torch.arange(settings.width * settings.height, dtype=torch.int32, device=dev)
    px = (ids % settings.width).to(torch.float32)
    py = (ids // settings.width).to(torch.float32)
    prev_t = torch.full(px.shape, float("inf"), device=dev)
    return gen_rays(cam_t, settings, px, py, PixelRng(0, ids), 0, prev_t)


def _light0(ts) -> Vec3:
    return Vec3(ts.lights.pos.x[0], ts.lights.pos.y[0], ts.lights.pos.z[0])


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _equal_or_raise(what: str, got, ref) -> dict:
    """Bitwise comparison of two output tuples; raises on any mismatch."""
    got, ref = (x if isinstance(x, tuple) else (x,) for x in (got, ref))
    mism = {i: int((a != b).sum()) for i, (a, b) in enumerate(zip(got, ref))}
    if any(mism.values()) or len(got) != len(ref):
        raise AssertionError(f"{what}: kernel differs from its plain version: {mism}")
    return mism


def _max_err(a, b) -> float:
    """Largest |a - b| over the finite entries of ``b`` (t = +inf on a
    miss); bool outputs compare as 0/1."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        raise AssertionError("kernel and plain disagree on which rays hit")
    fin = torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0


# ---------------------------------------------------------------- Cornell --

def _ceiling_first(tris) -> TrianglesSoA:
    """``tris`` after a ceiling: face 0 is one large triangle in the plane
    y = 5, between every point below it near the origin and a light at
    (0, 10, 0)."""
    dev = tris.mtl.device

    def cat(v: Vec3, first) -> Vec3:
        return Vec3(*(torch.cat([torch.tensor([f], dtype=torch.float32, device=dev), c])
                      for f, c in zip(first, v)))

    v0 = (-1e3, 5.0, -1e3)
    return TrianglesSoA(cat(tris.v0, v0), cat(tris.e1, (4e3, 0.0, 0.0)),
                        cat(tris.e2, (0.0, 0.0, 4e3)), cat(tris.n0, (0.0, -1.0, 0.0)),
                        cat(tris.n1, (0.0, -1.0, 0.0)), cat(tris.n2, (0.0, -1.0, 0.0)),
                        torch.cat([tris.mtl[:1], tris.mtl]))


def cornell_kernel_phase(scene, cam, dev) -> dict:
    """K1, K1', K2 and K2' against their plain versions, bitwise; returns
    the largest |t| errors and the path-shape rays for timing."""
    ts = to_torch(scene, dev)
    l0 = _light0(ts)
    cam_o, cam_d = _camera_rays(camera_to_torch(cam, dev), bench_settings(SIZE), dev)

    def soup_tris(nf: int):
        return to_torch(scene_from_text(random_soup(nf), use_bvh=False)[0], dev).tris

    # Face counts across the kernels' staged chunk (256 faces) and twice
    # that; a scene whose every shadow ray is occluded by face 0, with more
    # than a chunk of faces after it (the block leaves the shadow leg).
    down_o, down_d = _rays_in_box(65_536, 4, dev)
    down_d = Vec3(down_d.x, -down_d.y.abs(), down_d.z)
    above = Vec3(*(torch.tensor(v, device=dev) for v in (0.0, 10.0, 0.0)))
    cases = [
        ("cornell camera rays", ts.tris, cam_o, cam_d, l0),
        ("cornell random rays", ts.tris, *_rays_in_box(1_000_003, 1, dev), l0),
        ("soup:4000", soup_tris(4000), *_rays_in_box(65_536, 2, dev), l0),
        *((f"soup:{nf}", soup_tris(nf), *_rays_in_box(65_536, 3, dev), l0)
          for nf in (1, 255, 256, 257, 511, 512, 513)),
        ("every shadow ray occluded", _ceiling_first(soup_tris(600)), down_o, down_d, above),
    ]
    errs = {"K1": 0.0, "K1'": 0.0}
    for name, tris, o, d, lp in cases:
        light = torch.stack(list(lp))
        for variant, table, key in (("mt", ci.face_table(tris), "K1"),
                                    ("lin", ci.lin_table(tris), "K2")):
            t, f, occ = ci.intersect_fused(o, d, tris, light_pos=lp, variant=variant)
            t1, f1 = ci.intersect_fused(o, d, tris, variant=variant)
            tp, fp, op = ci.intersect_fused_plain(o, d, table, light)
            torch.cuda.synchronize()
            mism = _equal_or_raise(f"{key} on {name}", (t, f, occ, t1, f1), (tp, fp, op, tp, fp))
            if key == "K1":
                errs["K1"] = max(errs["K1"], _max_err(t, tp))
                errs["K1'"] = max(errs["K1'"], _max_err(t1, tp))
        if name == "every shadow ray occluded" and not bool(occ.all()):
            raise AssertionError(f"{name}: {int((~occ).sum())} shadow rays unoccluded")
        phase("kernel", f"{name}: {o.x.shape[0]} rays x {tris.mtl.shape[0]} faces, "
                        f"{int((f >= 0).sum())} hits, {int(occ.sum())} occluded; K1, K1', K2 "
                        f"and K2' mismatches against plain (t, face, occ, t', face') {mism}")
    # Faces against the plain sweep on the host's CPU, on a subset of camera
    # rays (CPU tensors take the plain version and launch nothing).
    sub = slice(0, 1 << 16)
    o_s = Vec3(*(c[sub].contiguous() for c in cam_o))
    d_s = Vec3(*(c[sub].contiguous() for c in cam_d))
    t_h, f_h = ci.intersect_fused(Vec3(*(c.cpu() for c in o_s)), Vec3(*(c.cpu() for c in d_s)),
                                  to_torch(scene, "cpu").tris)
    t_k, f_k = ci.intersect_fused(o_s, d_s, ts.tris)
    n_bad = int((f_k.cpu() != f_h).sum())
    n_t = int((t_k.cpu() != t_h).sum())
    phase("kernel", f"vs the plain sweep on the CPU, {f_h.numel()} camera rays: "
                    f"{n_bad} face mismatches, {n_t} t mismatches")
    if n_bad:
        raise AssertionError("K1 faces differ from the plain sweep on the CPU")
    return {"errs": errs, "tris": ts.tris, "o": cam_o, "d": cam_d, "light": l0}


def oracle_phase(tag: str, scene, cam, dev, size: int = 128, host_min_rays: tuple = (),
                 **kw) -> None:
    """The card's path (auto, probed schedule and lane order, compaction on
    the device) against the CPU's (plain versions, full width, scanline),
    at ``size``² (``kw``: settings, such as Phong tessellation;
    ``host_min_rays``: the Phong dispatch's ``CLUSTER_MIN_RAYS`` for the
    CPU frame, one element, the band's where empty)."""
    pt = PathTracer(scene, bench_settings(size, compact_schedule="auto", **kw), device=dev)
    pt.render(cam, frame_seed=5)
    got = pt.image()
    host = PathTracer(scene, bench_settings(size, **kw), device="cpu", lane_order="scanline")
    with phongtess.threshold(host_min_rays[0] if host_min_rays else phongtess.CLUSTER_MIN_RAYS):
        host.render(cam, frame_seed=5)
    ref = host.image()
    if np.isnan(got).any():
        raise AssertionError(f"{tag}: NaN in the {size}² frame")
    d = np.abs(got - ref).max(axis=-1)
    within = float((d <= 1e-3).mean())
    phase("oracle", f"{tag} {size}² frame ({pt.lane_order}, schedule "
                    f"{pt.settings.compact_schedule}) vs the CPU path: {within:.4%} of pixels "
                    f"within 1e-3, max |diff| {d.max():.3g}, means {got.mean():.6f} / "
                    f"{ref.mean():.6f}")
    if within < 0.99:
        raise AssertionError(f"{tag}: only {within:.4%} of pixels within 1e-3 of the CPU path")


def _first_frame_checks(tag: str, scene, cam, dev, **kw) -> PathTracer:
    """Probe, render frame 0, and hold it bitwise to the same frame traced
    at full width in the same lane order (``kw``: settings, such as the
    intersector)."""
    pt = PathTracer(scene, bench_settings(SIZE, compact_schedule="auto", **kw), device=dev)
    pt.render(cam, frame_seed=0)
    phase(tag, f"lane order {pt.lane_order}, compaction schedule {pt.settings.compact_schedule}")
    wide = PathTracer(scene, bench_settings(SIZE, **kw), device=dev, lane_order=pt.lane_order)
    wide.render(cam, frame_seed=0)
    n_diff = int((pt.image() != wide.image()).any(axis=-1).sum())
    phase(tag, f"first frame compacted vs full width: {n_diff} pixels differ")
    if n_diff:
        raise AssertionError(f"{tag}: compaction changed {n_diff} pixels of the first frame")
    return pt


# (path segments, shadow rays) of frame seed 0 of each timed path, by tag
# (``_timed_frames``): the bench phase holds the bench's count to them.
PATH_RAYS = {}


def _timed_frames(tag: str, pt: PathTracer, cam) -> tuple:
    """2 warm-up frames (frame 0 already rendered), then FRAMES timed
    frames with the launch counts zeroed just before and read just after."""
    for i in range(1, WARMUP):
        pt.render(cam, frame_seed=i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    zero_counts()
    start.record()
    for i in range(WARMUP, WARMUP + FRAMES):
        pt.render(cam, frame_seed=i)
    end.record()
    end.synchronize()
    launched = counts()
    ms_frame = start.elapsed_time(end) / FRAMES
    peak = torch.cuda.max_memory_allocated()
    img = pt.image()
    mean = float(img.mean())
    phase(tag, f"launches over {FRAMES} frames: {launched}")
    phase(tag, f"image {img.shape}, finite {bool(np.isfinite(img).all())}, mean {mean:.6f}")
    if not np.isfinite(img).all() or not 0.05 < mean < 5.0:
        raise AssertionError(f"{tag}: implausible image: mean {mean}")
    # Rays per frame from the counters (path segments + shadow rays, as
    # bench.py counts them), and the compaction drop count.
    res = trace_rays(pt.scene, camera_to_torch(cam, pt.device), pt.settings, pt.pixel_ids, 0,
                     with_stats=True, max_leaf=pt.max_leaf)
    n_path, n_shadow = int(res.n_path_rays), int(res.n_shadow_rays)
    n_drop = int(res.n_dropped) if res.n_dropped is not None else 0
    rays = n_path + n_shadow
    PATH_RAYS[tag] = (n_path, n_shadow)
    phase(tag, f"{n_path} path segments + {n_shadow} shadow rays = {rays} rays/frame; "
               f"{n_drop} lanes dropped by compaction")
    if n_drop:
        raise AssertionError(f"{tag}: compaction dropped {n_drop} live lanes")
    pool = pt.graph.pool_bytes if pt.graph is not None and pt.graph.pool_bytes else 0
    phase(tag, f"{ms_frame:.3f} ms/frame (replays of the frame's CUDA graph), "
               f"{rays / ms_frame / 1e3:.3f} M rays/s forward, peak memory "
               f"{peak / 2**20:.1f} MiB allocated and the graph's pool {pool / 2**20:.1f} MiB")
    return launched, ms_frame


def cornell_path_phase(scene, cam, dev, k1: dict, profile: bool) -> dict:
    pt = _first_frame_checks("cornell", scene, cam, dev)
    launched, _ = _timed_frames("cornell", pt, cam)
    expect = FRAMES * pt.settings.max_total_depth * pt.settings.samples
    if launched["K1"] != expect or sum(_searches(launched).values()) != expect:
        raise AssertionError(f"cornell: expected {expect} K1 launches and no other, got {launched}")
    _shade_pattern("cornell", launched, FRAMES, pt.settings)
    _compact_pattern("cornell", launched, FRAMES, pt.settings)
    t, o, d, light = k1["tris"], k1["o"], k1["d"], k1["light"]
    table = ci.face_table(t)
    light3 = torch.stack(list(light))
    # The kernel is shorter than the wrapper's host time a call, so 20 calls
    # are timed as a CUDA graph (the device's time); in a row, for reference.
    calls = {"K1": (lambda: ci.intersect_fused(o, d, t, light_pos=light),
                    lambda: ci.intersect_fused_plain(o, d, table, light3)),
             "K1'": (lambda: ci.intersect_fused(o, d, t),
                     lambda: ci.intersect_fused_plain(o, d, table))}
    out = {name: (k1_sweep.graph_ms(fn, 20), _time_ms(plain, 5))
           for name, (fn, plain) in calls.items()}
    bounds = _sweep_bounds("K1", o, d, t, light, lin=False)
    for name, (ms, plain) in out.items():
        phase("cornell", f"{name} per call at the path's shape ({o.x.shape[0]} rays x "
                         f"{table.shape[1]} faces): {ms:.4f} ms (20 calls in a row: "
                         f"{_time_ms(calls[name][0], 20):.4f} ms); plain version {plain:.4f} ms; "
                         f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]})")
    if profile:
        profile_phase("cornell", pt, cam)
    return {"launches": launched, "times": out, "bounds": bounds}


def _full_sweep_bounds(counts: dict, n: int, nf: int, lin: bool) -> tuple:
    """Bounds of a full sweep with NEE (K1, or K2 with ``lin``) and of its
    nearest-only instance, on ``n`` rays against ``nf`` faces, from
    ``k1_sweep.sweep_counts``: t for every test, u and v only where t can
    change the result (nearest ``1e-5 <= t <=`` the ray's final t; the
    shadow leg up to and including each ray's first occluder). Bytes: the
    rays, the (9, F) or (16, F) table, the light, t, face and occluded."""
    op_t, op_uv = (OPS_LIN_T, OPS_LIN_UV) if lin else (OPS_CLASSIC_T, OPS_CLASSIC_UV)
    table = 4 * (16 if lin else 9) * nf
    near = op_t * counts["tests"] + op_uv * counts["uv_tests"]
    shadow = op_t * counts["shadow_tests"] + op_uv * counts["shadow_uv_tests"]
    return (_bound(near + shadow, 24 * n + table + 12 + 12 * n),
            _bound(near, 24 * n + table + 8 * n))


def _sweep_bounds(name: str, o, d, tris, light, lin: bool) -> dict:
    """{name: the NEE instance's bound, name': the nearest one's} on rays
    ``o``, ``d`` (light 0 ``light``, a Vec3), with the counts printed."""
    table = ci.lin_table(tris) if lin else ci.face_table(tris)
    counts = k1_sweep.sweep_counts(o, d, table, torch.stack(list(light)))
    phase("kernels", f"{name} on {o.x.shape[0]} rays x {table.shape[1]} faces: nearest "
                     f"{counts['tests']} tests, {counts['uv_tests']} whose t can change the "
                     f"result, {counts['skip_tests']} with no division; shadow "
                     f"{counts['shadow_tests']} up to each ray's first occluder, "
                     f"{counts['shadow_uv_tests']} whose t can change the result, "
                     f"{counts['shadow_skip_tests']} with no division; {counts['occluded']} "
                     f"rays and {counts['occluded_warps']} of {counts['warps']} warps occluded")
    n, nf = o.x.shape[0], table.shape[1]
    nee, near = _full_sweep_bounds(counts, n, nf, lin)
    if not lin:  # the whole test on every face, and the shadow leg of unoccluded rays
        whole = (_bound(OPS_CLASSIC * nf * (2 * n - counts["occluded"]), 1.0),
                 _bound(OPS_CLASSIC * nf * n, 1.0))
        phase("kernels", f"{name}: bound {nee[0]:.4f} ms, nearest {near[0]:.4f} ms; charged "
                         f"the whole test on every face {whole[0][0]:.4f} / {whole[1][0]:.4f} ms")
    return {name: nee, name + "'": near}


def cornell_nee_off_phase(scene, cam, dev) -> dict:
    """Path "cornell, NEE off": one 1024² frame with shadow_rays=0 runs K1'."""
    pt = PathTracer(scene, bench_settings(SIZE, shadow_rays=0), device=dev,
                    lane_order="scanline")
    zero_counts()
    pt.render(cam, frame_seed=0)
    torch.cuda.synchronize()
    launched = counts()
    expect = pt.settings.max_total_depth
    phase("cornell NEE off", f"launches over one frame: {launched}")
    if launched["K1'"] != expect or sum(_searches(launched).values()) != expect:
        raise AssertionError(f"NEE off: expected {expect} K1' launches and no other")
    img = pt.image()
    if not np.isfinite(img).all() or not img.mean() > 0.05:
        raise AssertionError("NEE off: implausible image")
    return launched


# -------------------------------------------------------------- multiroom --

def multiroom_path_phase(scene, cam, dev, profile: bool) -> dict:
    pt = _first_frame_checks("multiroom", scene, cam, dev)
    first = pt.image()
    # The same frame through K1 (intersector 'pallas', the classic form):
    # the two Moller-Trumbore forms round differently at shared edges, so
    # the gate is the frame gate, not bitwise.
    k1 = PathTracer(scene, pt.settings.replace(intersector="pallas"), device=dev,
                    lane_order=pt.lane_order)
    k1_launches = _one_frame_launches("multiroom, pallas", k1, cam, seed=0)
    _expect("multiroom, pallas", k1_launches, {"K1": k1.settings.max_total_depth})
    d = np.abs(first - k1.image()).max(axis=-1)
    within = float((d <= 1e-3).mean())
    phase("multiroom", f"first frame, auto (K3) vs intersector='pallas' (K1): {within:.4%} of "
                       f"pixels within 1e-3, means {first.mean():.6f} / {k1.image().mean():.6f}")
    if within < 0.99:
        raise AssertionError(f"multiroom: K3 and K1 frames agree on only {within:.4%}")
    del k1
    launched, ms_frame = _timed_frames("multiroom", pt, cam)
    expect = FRAMES * pt.settings.max_total_depth * pt.settings.samples
    if launched["K3"] != expect or launched["K3 any-hit"] != expect:
        raise AssertionError(f"multiroom: expected {expect} K3 launches of each pass, "
                             f"got {launched}")
    if launched["K1"] or launched["K1'"] or launched["K2"] or launched["K2'"]:
        raise AssertionError(f"multiroom: auto launched another kernel than K3: {launched}")
    if profile:
        profile_phase("multiroom", pt, cam)
    return {"pt": pt, "launches": launched, "ms_frame": ms_frame,
            "k1_launches": k1_launches["K1"]}


def _gated_passes(o, d, tris, clusters, light, alive):
    """Run the gated wrapper with K3, recording each pass's kernel
    arguments, so that each pass can be replayed alone."""
    passes = []

    def record(*args):
        passes.append(args)
        return cg._sweep_kernel(*args)

    cg._gated(record, o, d, tris, clusters, light, alive, 8, True)
    return passes


def multiroom_kernel_phase(scene, cam, dev, pt: PathTracer) -> dict:
    """K3 and K2 against their plain versions, bitwise; K3 against K2 on
    live lanes; times per call of K3, K2 and K1 on the same rays."""
    ts = pt.scene
    tris, clusters, l0 = ts.tris, ts.clusters, _light0(ts)
    light = torch.stack(list(l0))
    cam_o, cam_d = _camera_rays(camera_to_torch(cam, dev), pt.settings, dev, pt.pixel_ids)
    n = BOUNCE_RAYS
    bo, bd = _rays_in_rooms(n, 3, dev)
    b_alive = torch.tensor(np.random.default_rng(4).random(n) < 0.6, device=dev)
    s_alive = torch.tensor(np.random.default_rng(5).random(n) < 0.15, device=dev)
    cases = [("camera rays, " + pt.lane_order, cam_o, cam_d, None),
             (f"{n} bounce-like rays, 60% alive", bo, bd, b_alive),
             (f"{n} bounce-like rays, 15% alive", bo, bd, s_alive)]
    lin = ci.lin_table(tris)
    errs = dict.fromkeys(("K2", "K2'", "K3", "K3 any-hit"), 0.0)
    for name, o, d, alive in cases:
        got = cg.intersect_gated(o, d, tris, clusters, light_pos=l0, alive=alive, with_counts=True)
        ref = cg.intersect_gated_plain(o, d, tris, clusters, light_pos=l0, alive=alive,
                                       with_counts=True)
        nearest = cg.intersect_gated(o, d, tris, clusters, alive=alive)
        torch.cuda.synchronize()
        _equal_or_raise(f"K3 on {name}", (*got, *nearest), (*ref, *ref[:2]))
        k2 = ci.intersect_fused(o, d, tris, light_pos=l0, variant="lin")
        k2n = ci.intersect_fused(o, d, tris, variant="lin")
        k2p = ci.intersect_fused_plain(o, d, lin, light)
        torch.cuda.synchronize()
        _equal_or_raise(f"K2 on {name}", (*k2, *k2n), (*k2p, *k2p[:2]))
        for key, a, b in (("K3", got[0], ref[0]), ("K3", nearest[0], ref[0]),
                          ("K3 any-hit", got[2], ref[2]), ("K2", k2[0], k2p[0]),
                          ("K2'", k2n[0], k2p[0])):
            errs[key] = max(errs[key], _max_err(a, b))
        live = torch.ones_like(got[1], dtype=torch.bool) if alive is None else alive
        vs_k2 = int((got[1][live] != k2[1][live]).sum())
        hit = live & (got[1] >= 0)
        occ_vs_k2 = int((got[2][hit] != k2[2][hit]).sum())
        tests = got[3].to(torch.float64)
        phase("kernels", f"multiroom {name}: K3 (nearest, any-hit, counts) and K2 (NEE, "
                         f"nearest) equal their plain versions bitwise; {int(hit.sum())} of "
                         f"{int(live.sum())} live lanes hit; K3 vs K2 on live lanes: {vs_k2} "
                         f"face and {occ_vs_k2} occlusion mismatches; K3 tests a lane: mean "
                         f"{float(tests[live].mean()):.1f} of the full sweeps' "
                         f"{2 * tris.mtl.shape[0]}")
    # Times on the path's camera rays: K3's two passes alone (recorded
    # arguments replayed), the whole wrapper (cull + both passes), K2, K1.
    p_near, p_any = _gated_passes(cam_o, cam_d, tris, clusters, l0, None)
    real = cg.real_faces(int(tris.mtl.shape[0]), clusters.count, dev)
    gated_bounds = {}
    for key, args in (("K3", p_near), ("K3 any-hit", p_any)):
        ref = cg._sweep_plain(*args)
        _equal_or_raise("K3 pass replay", cg._sweep_kernel(*args), ref)
        gated_bounds[key] = _gated_bound(args, real, ref)
    phase("kernels", f"K3 verdicts on the camera rays: {float(p_near[3].double().mean()):.4f} "
                     f"of (tile, cluster) pairs gated in for the nearest pass, "
                     f"{float(p_any[3].double().mean()):.4f} for the any-hit pass")
    table = ci.face_table(tris)
    k1 = ci.intersect_fused(cam_o, cam_d, tris, light_pos=l0)
    k1n = ci.intersect_fused(cam_o, cam_d, tris)
    k1p = ci.intersect_fused_plain(cam_o, cam_d, table, light)
    torch.cuda.synchronize()
    _equal_or_raise("K1 on the multiroom camera rays", (*k1, *k1n), (*k1p, *k1p[:2]))
    errs["K1 (multiroom)"] = max(_max_err(k1[0], k1p[0]), _max_err(k1n[0], k1p[0]))
    phase("kernels", "multiroom camera rays: K1 (NEE, nearest) equals its plain version bitwise")
    bounds = {**_sweep_bounds("K2", cam_o, cam_d, tris, l0, lin=True),
              "K1 (multiroom)": _sweep_bounds("K1 (multiroom)", cam_o, cam_d, tris, l0,
                                              lin=False)["K1 (multiroom)"],
              **gated_bounds}
    times = {
        "K3": (_time_ms(lambda: cg._sweep_kernel(*p_near), 20),
               _time_ms(lambda: cg._sweep_plain(*p_near), 3)),
        "K3 any-hit": (_time_ms(lambda: cg._sweep_kernel(*p_any), 20),
                       _time_ms(lambda: cg._sweep_plain(*p_any), 3)),
        "K3 wrapper": (_time_ms(lambda: cg.intersect_gated(cam_o, cam_d, tris, clusters,
                                                           light_pos=l0), 10),
                       _time_ms(lambda: cg.intersect_gated_plain(cam_o, cam_d, tris, clusters,
                                                                 light_pos=l0), 3)),
        "K2": (_time_ms(lambda: ci.intersect_fused(cam_o, cam_d, tris, light_pos=l0,
                                                   variant="lin"), 10),
               _time_ms(lambda: ci.intersect_fused_plain(cam_o, cam_d, lin, light), 2)),
        "K2'": (_time_ms(lambda: ci.intersect_fused(cam_o, cam_d, tris, variant="lin"), 10),
                _time_ms(lambda: ci.intersect_fused_plain(cam_o, cam_d, lin), 2)),
        "K1 (multiroom)": (_time_ms(lambda: ci.intersect_fused(cam_o, cam_d, tris,
                                                               light_pos=l0), 10),
                           _time_ms(lambda: ci.intersect_fused_plain(cam_o, cam_d, table,
                                                                     light), 2)),
    }
    for name, (ms, plain) in times.items():
        b = f"; bound {bounds[name][0]:.4f} ms ({bounds[name][1]})" if name in bounds else ""
        phase("kernels", f"{name} per call on the multiroom camera rays ({cam_o.x.shape[0]} "
                         f"rays x {tris.mtl.shape[0]} faces): {ms:.4f} ms; plain version "
                         f"{plain:.4f} ms{b}")
    return {"times": times, "errs": errs, "bounds": bounds, "o": cam_o, "d": cam_d}


def _gated_bound(args, real, out) -> tuple:
    """Bound of one K3 pass from its recorded arguments and its plain
    result ``out``: t for the gated-in clusters' real faces for every ray
    of the tile, u and v for the tests whose t can change the result
    (``k3_tiles.pass_counts``: nearest 1e-5 <= t <= the final t, any-hit up
    to and including the first occluder)."""
    o, _, tab, verdict, _, _, _, t_limit = args
    n = o.x.shape[0]
    work = k3_tiles.pass_counts(args, real, out if isinstance(out, tuple) else (out,))
    any_hit = t_limit is not None
    # rays, the seeds (nearest: t and face; any-hit: occlusion and t_limit),
    # table, verdicts, outputs
    nbytes = 24 * n + 8 * n + 4 * tab.numel() + verdict.numel() + (4 if any_hit else 8) * n
    phase("kernels", f"K3 {'any-hit' if any_hit else 'nearest'} pass on the camera rays: "
                     f"{work['tests']} real-face tests, {work['uv_tests']} whose t can change "
                     f"the result; {work['closed_warps']} of {work['warps']} warp sections "
                     f"closed at entry")
    return _bound(OPS_LIN_T * work["tests"] + OPS_LIN_UV * work["uv_tests"], nbytes)


def _grads(ts, cam_t, settings, ids, weights=None) -> tuple:
    """bench.py's step (bench.py:350-378): loss = the sum of the frame's
    colors (optionally weighted per pixel); gradients to every parameter of
    ``ts`` and to the eye."""
    params = [p for _, p in ts.named_parameters()] + list(cam_t.eye)
    res = trace_rays(ts, cam_t, settings, ids, 1)
    terms = res.color.x + res.color.y + res.color.z
    if weights is not None:
        terms = terms * weights
    loss = terms.sum()
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    return loss, grads, res.color.stack().detach()


def _grads_card_vs_cpu(tag: str, scene, cam, dev, settings: RenderSettings) -> None:
    """The card's gradients of bench.py's step (its shade's backward K12
    bwd, the camera's K11 bwd) against the CPU path's (the plain adjoints)
    (``_grads_agree``)."""
    _grads_agree(tag, scene, cam, (dev, settings), ("cpu", settings), "card vs CPU")


def _grads_agree(tag: str, scene, cam, run, ref, what: str) -> None:
    """The gradients of bench.py's step in ``run`` against those in ``ref``,
    each a (device, settings) or a (device, settings, the Phong dispatch's
    ``CLUSTER_MIN_RAYS`` for it), over the pixels whose colors agree within
    1e-3 (a ULP of a transcendental can flip a path's discrete decision,
    and a flipped pixel has another gradient): every parameter within 1e-3
    of its largest magnitude."""
    size = run[1].width
    out, band = [], []
    for dv, settings, *thr in (run, ref):
        tsd = to_torch(scene, dv).requires_grad_()
        cd = camera_to_torch(cam, dv)
        for c in cd.eye:
            c.requires_grad_()
        out.append((tsd, cd, settings, torch.arange(size * size, dtype=torch.int32, device=dv)))
        band.append(thr[0] if thr else phongtess.CLUSTER_MIN_RAYS)
    names = [n for n, _ in out[1][0].named_parameters()] + ["eye.x", "eye.y", "eye.z"]
    col = []
    for v, b in zip(out, band):
        with torch.no_grad(), phongtess.threshold(b):  # _grads' seed
            col.append(trace_rays(*v, 1).color.stack().cpu().numpy())
    agree = (np.abs(col[0] - col[1]).max(axis=1) <= 1e-3)
    if agree.mean() < 0.99:
        raise AssertionError(f"{tag}: {size}² colors, {what}: only {agree.mean():.4%} of "
                             f"pixels agree")
    w = torch.tensor(agree.astype(np.float32))
    grads = []
    for v, b in zip(out, band):
        with phongtess.threshold(b):
            grads.append(_grads(*v, w.to(v[3].device))[1])
    g_run, g_ref = grads
    worst = 0.0
    for name, a, b in zip(names, g_run, g_ref):
        a, b = a.cpu().double(), b.cpu().double()
        scale = float(b.abs().max()) if b.numel() else 0.0
        err = float((a - b).abs().max()) if b.numel() else 0.0
        tol = 1e-3 * scale + 1e-5
        worst = max(worst, err / tol if tol else 0.0)
        if err > tol:
            raise AssertionError(f"{tag}: {size}² gradient {name}, {what}: max |diff| "
                                 f"{err} > {tol}")
    phase(tag, f"{size}² gradients, {what}, over the {agree.mean():.4%} of pixels whose "
               f"colors agree: every parameter within 1e-3 of its largest magnitude (worst "
               f"at {worst:.3f} of that bound)")


def multiroom_grad_phase(scene, cam, dev, pt: PathTracer, profile: bool) -> dict:
    """Path "multiroom, forward+backward" at 1024² (K3 and K3 any-hit once
    a bounce; K11, K12, K11 bwd and K12 bwd: ``_shade_pattern``), then the
    card's 64² gradients against the CPU's (the plain adjoints)."""
    ts = pt.scene.requires_grad_()
    cam_t = camera_to_torch(cam, dev)
    for c in cam_t.eye:
        c.requires_grad_()
    loss, grads, _ = _grads(ts, cam_t, pt.settings, pt.pixel_ids)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(STEPS):
        loss, grads, _ = _grads(ts, cam_t, pt.settings, pt.pixel_ids)
    end.record()
    end.synchronize()
    launched = counts()
    ms_step = start.elapsed_time(end) / STEPS
    peak = torch.cuda.max_memory_allocated()
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    names = [n for n, _ in ts.named_parameters()] + ["eye.x", "eye.y", "eye.z"]
    kd = dict(zip(names, grads))["mat_kd"]
    phase("fwd+bwd", f"launches over {STEPS} steps: {launched}")
    phase("fwd+bwd", f"{SIZE}² step: {ms_step:.3f} ms/step (forward+backward), peak memory "
                     f"{peak / 2**20:.1f} MiB, loss {float(loss.detach()):.3f}, gradients finite "
                     f"{finite}, |d loss/d kd| max {float(kd.abs().max()):.4f}")
    expect = STEPS * pt.settings.max_total_depth
    if not finite or launched["K3"] != expect or launched["K3 any-hit"] != expect:
        raise AssertionError(f"fwd+bwd: finite {finite}, launches {launched}")
    _shade_pattern("fwd+bwd", launched, STEPS, pt.settings, backward=True)
    _compact_pattern("fwd+bwd", launched, STEPS, pt.settings, backward=True)
    if profile:
        profile_phase("multiroom forward+backward", pt, cam,
                      lambda: _grads(ts, cam_t, pt.settings, pt.pixel_ids))
    ts.requires_grad_(False)

    _grads_card_vs_cpu("fwd+bwd", scene, cam, dev,
                       bench_settings(64, no_transparency=pt.settings.no_transparency))
    return {"launches": launched, "ms_step": ms_step, "peak": peak}


def lin_path_phase(scene, dev, mk: dict) -> dict:
    """Path "linear form": K2's entry point on the multiroom camera rays."""
    ts = to_torch(scene, dev)
    zero_counts()
    ci.intersect_fused(mk["o"], mk["d"], ts.tris, light_pos=_light0(ts), variant="lin")
    ci.intersect_fused(mk["o"], mk["d"], ts.tris, variant="lin")
    torch.cuda.synchronize()
    launched = counts()
    phase("linear form", f"launches: {launched}")
    if launched["K2"] != 1 or launched["K2'"] != 1 or sum(_searches(launched).values()) != 2:
        raise AssertionError(f"linear form: expected one K2 and one K2' launch, got {launched}")
    return launched


# ------------------------------------------------------ cull-and-sweep --

def _cull_passes(o, d, clusters, light, alive):
    """Run the cull wrapper with the kernels, recording each pass's
    arguments (K4's or K4m's), so that each pass can be replayed alone."""
    passes = []

    def slotted(*args):
        passes.append(("K4", args))
        return cc._slotted_kernel(*args)

    def masked(*args):
        passes.append(("K4m", args))
        return cc._masked_kernel(*args)

    out = cc._cull(slotted, masked, o, d, clusters, light, alive, "highest")
    return passes, out


def _slot_stats(slots: torch.Tensor) -> str:
    """Executed slots a tile: max, mean, and the top 1% of tiles' share of
    all executed slots."""
    top = torch.sort(slots.double(), descending=True).values
    k = max(1, -(-top.numel() // 100))
    return (f"executed slots a tile max {int(top[0])}, mean {float(top.mean()):.2f}, top 1% of "
            f"tiles {float(top[:k].sum() / top.sum().clamp_min(1)):.4f} of them")


def _cull_pass_bound(kind: str, args, work: dict) -> tuple:
    """Bound of one K4 or K4m pass: t for each real-face test and u and v
    for those whose t can change the result (``work``, from
    ``k4_tiles.pass_counts`` on the plain replay);
    bytes: the rays, the seeds (and t_limit), the compact table, the
    candidate tables or verdict bytes, the outputs."""
    feats, table = args[0], args[1]
    n = feats[0].shape[0]
    any_hit = args[-1]
    gate = sum(a.numel() * a.element_size() for a in args[2:5]) if kind == "K4" \
        else args[2].numel()
    nbytes = 24 * n + 8 * n + table.numel() * 4 + gate + (4 if any_hit else 8) * n
    return _bound(OPS_LIN_T * work["tests"] + OPS_LIN_UV * work["uv_tests"], nbytes)


def _cull_kernel_checks(tag: str, cases, clusters, light, tris) -> dict:
    """The cull wrapper with the kernels against its plain version,
    bitwise (t, face, occluded, and the nearest-only call's t and face),
    on each case; per pass of the first case, the plain replay, its
    executed tests and the pass's bound. Prints the candidate-slot share."""
    first = []
    errs = {}
    for i_case, (name, o, d, alive) in enumerate(cases):
        passes, got = _cull_passes(o, d, clusters, light, alive)
        nearest = cc.intersect_cull(o, d, clusters, alive=alive)
        ref = cc.intersect_cull_plain(o, d, clusters, light_pos=light, alive=alive)
        torch.cuda.synchronize()
        _equal_or_raise(f"{tag} cull on {name}", (*got, *nearest), (*ref, *ref[:2]))
        kind = passes[0][0]
        errs[kind] = max(errs.get(kind, 0.0), _max_err(got[0], ref[0]), _max_err(nearest[0], ref[0]))
        errs[kind + " any-hit"] = max(errs.get(kind + " any-hit", 0.0), _max_err(got[2], ref[2]))
        live = torch.ones_like(got[1], dtype=torch.bool) if alive is None else alive
        k1 = ci.intersect_fused(o, d, tris, light_pos=light)
        hit = live & (got[1] >= 0)
        phase(tag, f"{name}: {o.x.shape[0]} rays; {kind} (nearest, any-hit) and the nearest-only "
                   f"call equal the plain version bitwise; {int(hit.sum())} of "
                   f"{int(live.sum())} live lanes hit; against K1 on live lanes "
                   f"{int((got[1][live] != k1[1][live]).sum())} face and "
                   f"{int((got[2][hit] != k1[2][hit]).sum())} occlusion mismatches")
        shares = []
        for kind_i, args in passes:
            pass_name = kind_i + (" any-hit" if args[-1] else "")
            out, work, slots = k4_tiles.pass_counts(kind_i, args)
            _equal_or_raise(f"{pass_name} replay on {name}", cc._slotted_kernel(*args)
                            if kind_i == "K4" else cc._masked_kernel(*args), out)
            c, s = args[1].shape[:2]
            if kind_i == "K4":
                cand, cnt = args[2], args[3]
                listed = (cand < cc.CAND_MISS) & (
                    torch.arange(c, device=cand.device)[None, :] < cnt[:, None])
            else:
                listed = args[2]
            share = listed.sum(dim=1).double() / c
            full = work["tests"] / (share.numel() * cc.TILE * c * s)
            shares.append(f"{pass_name}: listed {float(share.mean()):.4f} (tile min "
                          f"{float(share.min()):.4f}, max {float(share.max()):.4f}), executed "
                          f"{full:.4f} of all (tile, face) pairs, {_slot_stats(slots)}")
            if i_case == 0:
                first.append((pass_name, kind_i, args, work))
        phase(tag, f"{name}: candidate-slot share per tile (slots listed without the miss "
                   f"bit, over C); " + "; ".join(shares))
    return {"errs": errs, "passes": first}


def _time_passes(tag: str, passes, what: str) -> dict:
    """Times of each recorded pass (kernel, and plain version), with its
    bound."""
    out = {}
    for pass_name, kind, args, work in passes:
        kern = cc._slotted_kernel if kind == "K4" else cc._masked_kernel
        plain = cc._slotted_plain if kind == "K4" else cc._masked_plain
        ms = _time_ms(lambda: kern(*args), 10)
        plain_ms = _time_ms(lambda: plain(*args), 1)
        bound = _cull_pass_bound(kind, args, work)
        out[pass_name] = (ms, plain_ms, bound)
        phase(tag, f"{pass_name} per pass on {what}: {ms:.4f} ms; plain version "
                   f"{plain_ms:.4f} ms; {work['tests']} real-face tests, {work['uv_tests']} "
                   f"whose t can change the result; bound {bound[0]:.4f} ms ({bound[1]})")
    return out


def multiroom_cull_phase(scene, cam, dev, mr_pt: PathTracer) -> dict:
    """Path "multiroom, cull": one 1024² frame with intersector='cull'
    (K4m, 32 clusters), against the auto (K3) frame; K4m against its plain
    version on the path's camera rays and on 1M bounce-like rays with an
    alive mask, with the tests whose t can change the result; timed on the
    camera rays."""
    settings = mr_pt.settings.replace(intersector="cull")
    pt = PathTracer(scene, settings, device=dev, lane_order=mr_pt.lane_order)
    zero_counts()
    pt.render(cam, frame_seed=0)
    torch.cuda.synchronize()
    launched = counts()
    expect = settings.max_total_depth * settings.samples
    phase("multiroom cull", f"launches over one frame: {launched}")
    if launched["K4m"] != expect or launched["K4m any-hit"] != expect \
            or sum(_searches(launched).values()) != 2 * expect:
        raise AssertionError(f"multiroom cull: expected {expect} K4m launches of each pass "
                             f"and no other, got {launched}")
    ref = PathTracer(scene, mr_pt.settings, device=dev, lane_order=mr_pt.lane_order)
    ref.render(cam, frame_seed=0)
    img = pt.image()
    d = np.abs(img - ref.image()).max(axis=-1)
    within = float((d <= 1e-3).mean())
    phase("multiroom cull", f"frame 0, intersector='cull' (K4m) vs auto (K3): {within:.4%} of "
                            f"pixels within 1e-3, means {img.mean():.6f} / "
                            f"{ref.image().mean():.6f}")
    if within < 0.99 or not np.isfinite(img).all():
        raise AssertionError(f"multiroom cull: K4m and K3 frames agree on only {within:.4%}")
    ts = pt.scene
    cam_o, cam_d = _camera_rays(camera_to_torch(cam, dev), settings, dev, pt.pixel_ids)
    nb = BOUNCE_RAYS
    bo, bd = _rays_in_rooms(nb, 3, dev)
    b_alive = torch.tensor(np.random.default_rng(4).random(nb) < 0.6, device=dev)
    chk = _cull_kernel_checks("multiroom cull", [("camera rays, " + pt.lane_order, cam_o,
                                                  cam_d, None),
                                                 (f"{nb} bounce-like rays, 60% alive", bo, bd,
                                                  b_alive)],
                              ts.clusters, _light0(ts), ts.tris)
    times = _time_passes("multiroom cull", chk["passes"],
                         f"the multiroom camera rays ({cam_o.x.shape[0]})")
    return {"launches": launched, "times": times, "errs": chk["errs"]}


def _rays_in_soup(n: int, seed: int, dev) -> tuple:
    """Bounce-like rays in the soup: origins inside its box, random unit
    directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.1, 1.1, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return _to_dev(o, dev), _to_dev(d, dev)


def auto_golden_phase(tag: str, scene, cam, dev) -> dict:
    """The device golden of ``auto`` on one scene (the counterpart of the
    JAX package's tools/golden_device.py): the first-frame checks at 1024²;
    the frame against the same frame through K1 (intersector='pallas',
    whose one frame launches K1 8 times and nothing else): at least 99% of
    pixels within 1e-3, no NaN; one frame's launches: those of the band
    table's pick (``AUTO_PICKS``) and no other; at 64², the card's
    gradients through ``auto`` against those through K1 (``_grads_agree``)."""
    pt = _first_frame_checks(tag, scene, cam, dev)
    first = pt.image()
    k1 = PathTracer(scene, pt.settings.replace(intersector="pallas"), device=dev,
                    lane_order=pt.lane_order)
    k1_launches = _one_frame_launches(f"{tag}, pallas", k1, cam, seed=0)
    mtd = k1.settings.max_total_depth
    _expect(f"{tag}, pallas", k1_launches, {"K1": mtd})
    _frame_vs(tag, "first frame, auto vs intersector='pallas' (K1)", first, k1.image())
    del k1
    launched = _one_frame_launches(f"{tag}, auto", pt, cam)
    _expect(f"{tag}, auto", launched, dict.fromkeys(AUTO_PICKS[tag], mtd))
    small = bench_settings(64, no_transparency=pt.settings.no_transparency)
    _grads_agree(tag, scene, cam, (dev, small), (dev, small.replace(intersector="pallas")),
                 "auto vs K1 on the card")
    return {"pt": pt, "first": first, "k1_launches": k1_launches["K1"], "launches": launched}


def band_golden_phase(dev) -> None:
    """``auto_golden_phase`` on a scene in each band the card's table moved
    (besides soup:100000, which the soup path takes): soup:1025, now K1's,
    and multiroom:6,6,30, now K8's. On soup:1025 auto is K1 itself, so its
    frame and gradient goldens hold K1 against K1 and can only pass: there
    the launch check (``AUTO_PICKS``) is what shows the band moved."""
    soup_cam = make_camera_state(eye=(0.0, 0.0, 3.5), center_dir=(0.0, 0.0, 1.0))
    room_cam = make_camera_state(eye=(0.0, 1.0, 3.0), center_dir=(0.0, 0.0, 1.0))
    for tag, text, cam in (("soup:1025", grey_soup(1_025), soup_cam),
                           ("multiroom:6,6,30", multi_room(6, 6, 30), room_cam)):
        scene, _ = scene_from_text(*text, use_bvh=True)
        auto_golden_phase(tag, scene, cam, dev)


def soup_path_phase(scene, cam, dev, profile: bool) -> dict:
    """Path "soup:100000": ``auto_golden_phase``; then path "soup:100000,
    cull" (K4, intersector='cull') at 1024²: the first-frame checks, the
    frame against auto's, 8 timed frames."""
    tag = "soup:100000"
    auto = auto_golden_phase(tag, scene, cam, dev)
    tag = "soup:100000 cull"
    pt = _first_frame_checks(tag, scene, cam, dev, intersector="cull")
    first = pt.image()
    _frame_vs(tag, "first frame, 'cull' (K4) vs auto", first, auto["first"])
    del auto["pt"]
    launched, ms_frame = _timed_frames(tag, pt, cam)
    expect = FRAMES * pt.settings.max_total_depth * pt.settings.samples
    if launched["K4"] != expect or launched["K4 any-hit"] != expect \
            or sum(_searches(launched).values()) != 2 * expect:
        raise AssertionError(f"{tag}: expected {expect} K4 launches of each pass and no "
                             f"other, got {launched}")
    if profile:
        profile_phase(tag, pt, cam)
    return {"pt": pt, "launches": launched, "ms_frame": ms_frame, "first": first,
            "k1_launches": auto["k1_launches"]}


def soup_kernel_phase(dev, pt: PathTracer, cam) -> dict:
    """K4 against its plain version on all the path's camera rays (in its
    lane order) and on bounce-like rays with an alive mask and NEE; times
    of K4's passes, of the wrapper, of its plain version and of K1 on the
    camera rays."""
    tag = "soup kernels"
    ts = pt.scene
    tris, clusters, l0 = ts.tris, ts.clusters, _light0(ts)
    cam_o, cam_d = _camera_rays(camera_to_torch(cam, dev), pt.settings, dev, pt.pixel_ids)
    n, nb = cam_o.x.shape[0], BOUNCE_RAYS
    bo, bd = _rays_in_soup(nb, 5, dev)
    b_alive = torch.tensor(np.random.default_rng(6).random(nb) < 0.6, device=dev)
    t0 = time.perf_counter()
    chk = _cull_kernel_checks(tag, [(f"all {n} camera rays, {pt.lane_order}", cam_o, cam_d,
                                     None),
                                    (f"{nb} bounce-like rays, 60% alive", bo, bd, b_alive)],
                              clusters, l0, tris)
    phase(tag, f"both comparisons with the plain version took "
               f"{time.perf_counter() - t0:.1f} s")
    what = f"all {n} camera rays x {tris.mtl.shape[0]} faces"
    times = _time_passes(tag, chk["passes"], what)
    times["K4 wrapper"] = (
        _time_ms(lambda: cc.intersect_cull(cam_o, cam_d, clusters, light_pos=l0), 5),
        _time_ms(lambda: cc.intersect_cull_plain(cam_o, cam_d, clusters, light_pos=l0), 1))
    phase(tag, f"on {what}: wrapper (sort, candidates, both passes) "
               f"{times['K4 wrapper'][0]:.4f} ms, plain {times['K4 wrapper'][1]:.4f} ms")
    # K1 (NEE) on the same rays: against its plain version (one call, timed),
    # timed, and its bound
    t0 = time.perf_counter()
    plain_ms, k1p = k1_sweep.time_once(lambda: ci.intersect_fused_plain(
        cam_o, cam_d, ci.face_table(tris), torch.stack(list(l0))))
    k1 = ci.intersect_fused(cam_o, cam_d, tris, light_pos=l0)
    torch.cuda.synchronize()
    _equal_or_raise("K1 on the soup:100000 camera rays", k1, k1p)
    errs = {**chk["errs"], "K1 (soup:100000)": _max_err(k1[0], k1p[0])}
    key = "K1 (soup:100000)"
    times[key] = (_time_ms(lambda: ci.intersect_fused(cam_o, cam_d, tris, light_pos=l0), 2),
                  plain_ms, _sweep_bounds(key, cam_o, cam_d, tris, l0, lin=False)[key])
    phase(tag, f"on {what}: K1 (NEE) {times[key][0]:.4f} ms, equal to its plain version "
               f"bitwise ({plain_ms:.1f} ms); bound {times[key][2][0]:.4f} ms "
               f"({times[key][2][1]}); {time.perf_counter() - t0:.1f} s in all")
    return {"times": times, "errs": errs}


# -------------------------------------------------------------- row sweep --

def _sweep_passes(o, d, clusters, light, alive):
    """Run the sweep wrapper with the kernels and its counters, recording
    each pass's arguments (K5's or K5m's), so that each pass can be
    replayed alone."""
    passes = []

    def slotted(*args):
        passes.append(("K5", args))
        return cs._slotted_kernel(*args)

    def masked(*args):
        passes.append(("K5m", args))
        return cs._masked_kernel(*args)

    out = cs._sweep(slotted, masked, o, d, clusters, light, alive, True)
    return passes, out


def _sweep_pass_plain(kind: str, args, uv: bool = False) -> tuple:
    """A recorded pass through the plain version, with what it ran: the
    (row, lin cluster) pairs, their real-face tests (32 rays x the lin
    cluster's real faces a pair) and the (tile, lin cluster) tables the
    kernel stages (one where any row of the tile runs); ``uv``: also the
    tests that need u and v (``_sweep_uv_tests``)."""
    lin = args[3]
    # m = e2 x e1 (rows 0-2) is 0 on padding faces
    real = (lin[:, 0:3, :] != 0).any(dim=1).sum(dim=1)
    work = []
    out = (cs._slotted_plain if kind == "K5" else cs._masked_plain)(*args, work=work)
    torch.cuda.synchronize()
    pairs = sum(int(r.numel()) for r, _ in work)
    tests = sum(int(real[c].sum()) for _, c in work) * cs.ROW
    staged = sum(int(torch.unique(r // cs.GROUPS).numel()) for r, _ in work)
    res = {"pairs": pairs, "tests": tests, "staged": staged}
    if uv:
        res["uv_tests"] = _sweep_uv_tests(args, work, out)
    return out, res


def _sweep_uv_tests(args, work, out) -> int:
    """The tests of a recorded pass whose t can change the result, the only
    ones whose u and v the function needs, from the plain version's t on
    its executed pairs: nearest, 1e-5 <= t <= the ray's final t; any-hit,
    1e-5 <= t < t_limit on a ray not occluded yet, in the plain version's
    order up to and including the ray's first occluder. Padding faces
    (det = 0, t NaN) are never counted."""
    rows = lambda a: a.reshape(-1, cs.ROW)  # noqa: E731
    o, d = Vec3(*map(rows, args[0])), Vec3(*map(rows, args[1]))
    c = ci.cross_od(o, d)
    t_limit, lin = args[2], args[3]
    if t_limit is not None:
        limit, occ = rows(t_limit), rows(args[-2]) > 0.0  # the 0/1 seed
    else:
        final = rows(out[0])
    step = max(1, cs._PLAIN_ELEMS // (cs.ROW * cs.LIN))
    n = 0
    for rws, cids in work:
        for k in range(0, rws.shape[0], step):
            rw, cd = rws[k:k + step], cids[k:k + step]
            tab = lin[cd].transpose(0, 1)[:, :, None, :]  # (16, k, 1, LIN)
            ray = lambda v: Vec3(*(a[rw][:, :, None] for a in v))  # noqa: E731
            t, valid = ci.mt_lin(ray(o), ray(d), ray(c), tab)  # (k, ROW, LIN)
            if t_limit is None:
                n += int(((t >= EPS5) & (t <= final[rw][:, :, None])).sum())
                continue
            lim = limit[rw][:, :, None]
            hit = valid & (t < lim)
            before = torch.cumsum(hit, dim=2, dtype=torch.int32) - hit.to(torch.int32)
            n += int(((t >= EPS5) & (t < lim) & (before == 0) & ~occ[rw][:, :, None]).sum())
            occ[rw] = occ[rw] | hit.any(dim=2)
    return n


def _sweep_pass_bound(kind: str, args, work: dict) -> tuple:
    """Bound of one K5 or K5m pass: t for each of its real-face tests, u
    and v for those whose t can change the result (``_sweep_uv_tests``);
    bytes, each input read once and each output written once: the rays
    (and t_limit), the seeds, the lin tables, the candidate tables or
    verdict words, the outputs. Also returns the time of the bytes the
    kernel stages (8 KB a staged table), which come from L2 and are printed
    beside the bound, not taken into it."""
    o, lin, any_hit = args[0], args[3], args[2] is not None
    n = o.x.shape[0]
    gate = sum(a.numel() * a.element_size() for a in args[4:7]) if kind == "K5" \
        else args[4].numel() * 4
    nbytes = (28 if any_hit else 24) * n + 8 * n + lin.numel() * 4 + gate \
        + (4 if any_hit else 8) * n
    staged = 8192 * work["staged"] / PEAK_BYTES * 1e3
    ops = OPS_LIN_T * work["tests"] + OPS_LIN_UV * work["uv_tests"]
    return _bound(ops, nbytes), staged


def _sweep_kernel_checks(tag: str, cases, clusters, light) -> dict:
    """The sweep wrapper with the kernels against its plain version,
    bitwise (t, face, occluded, the counters, and the nearest-only call's
    t and face), on each case; per pass of the first case, the plain
    replay, its executed pairs and tests, and the pass's bound. Prints the
    listed and executed shares of (row, slot) pairs."""
    first = []
    errs = {}
    for i_case, (name, o, d, alive) in enumerate(cases):
        passes, got = _sweep_passes(o, d, clusters, light, alive)
        nearest = cs.intersect_sweep(o, d, clusters, alive=alive)
        ref = cs.intersect_sweep_plain(o, d, clusters, light_pos=light, alive=alive,
                                       with_counts=True)
        torch.cuda.synchronize()
        _equal_or_raise(f"{tag} sweep on {name}", (*got, *nearest), (*ref, *ref[:2]))
        kind = passes[0][0]
        errs[kind] = max(errs.get(kind, 0.0), _max_err(got[0], ref[0]), _max_err(nearest[0], ref[0]))
        errs[kind + " any-hit"] = max(errs.get(kind + " any-hit", 0.0), _max_err(got[2], ref[2]))
        live = torch.ones_like(got[1], dtype=torch.bool) if alive is None else alive
        hit = live & (got[1] >= 0)
        phase(tag, f"{name}: {o.x.shape[0]} rays; {kind} (nearest, any-hit, counters) and the "
                   f"nearest-only call equal the plain version bitwise; {int(hit.sum())} of "
                   f"{int(live.sum())} live lanes hit, {int(got[2][hit].sum())} occluded; the "
                   f"verdicts ask for {float(got[3][live].double().mean()):.1f} face tests a live "
                   f"lane (both passes)")
        shares = []
        for kind_i, args in passes:
            pass_name = kind_i + (" any-hit" if args[2] is not None else "")
            out, work = _sweep_pass_plain(kind_i, args, uv=i_case == 0)
            _equal_or_raise(f"{pass_name} replay on {name}", cs._slotted_kernel(*args)
                            if kind_i == "K5" else cs._masked_kernel(*args), out)
            cl = args[3].shape[0]
            rows = args[0].x.shape[0] // cs.ROW
            if kind_i == "K5":
                listed = int(cs.listed_rows(args[4], args[5]).sum())
            else:
                w = args[4]
                listed = sum(int(((w >> b) & 1).sum()) for b in range(16))
            # the copy with the record: its pairs and staged tables equal
            st = k5_rows.record_pass(K5_RECORD, kind_i, args, (out if isinstance(out, tuple)
                                                               else (out,), work["pairs"],
                                                               work["staged"]))
            blocks = (f"; {st['rows_per_staged_slot']:.3f} active rows a staged table (of "
                      f"{cs.GROUPS}), staging {st['staging_share']:.2%} of a block's time, "
                      f"span {st['span_ms']:.4f} ms, last block "
                      f"{st['last_after_median_ms']:.4f} ms after the median")
            shares.append(f"{pass_name}: listed {listed / (rows * cl):.4f}, executed "
                          f"{work['pairs'] / (rows * cl):.4f} of the {rows} x {cl} (row, lin "
                          f"cluster) pairs ({work['pairs']} pairs, {work['tests']} real-face "
                          f"tests, {work['staged']} tables staged){blocks}")
            if i_case == 0:
                first.append((pass_name, kind_i, args, work))
        phase(tag, f"{name}: " + "; ".join(shares))
    return {"errs": errs, "passes": first}


def _time_sweep_passes(tag: str, passes, what: str) -> dict:
    """Times of each recorded pass (kernel, and plain version), with its
    bound."""
    out = {}
    for pass_name, kind, args, work in passes:
        kern = cs._slotted_kernel if kind == "K5" else cs._masked_kernel
        plain = cs._slotted_plain if kind == "K5" else cs._masked_plain
        ms = _time_ms(lambda: kern(*args), 10)
        plain_ms = _time_ms(lambda: plain(*args), 1)
        bound, staged = _sweep_pass_bound(kind, args, work)
        out[pass_name] = (ms, plain_ms, bound)
        phase(tag, f"{pass_name} per pass on {what}: {ms:.4f} ms; plain version "
                   f"{plain_ms:.4f} ms; {work['tests']} real-face tests, {work['uv_tests']} of them "
                   f"need u and v, bound {bound[0]:.4f} ms "
                   f"({bound[1]}); staged tables {staged:.4f} ms at 3.35 TB/s")
    return out


def multiroom_sweep_phase(scene, cam, dev, mr_pt: PathTracer) -> dict:
    """Path "multiroom, sweep": one 1024² frame with intersector='sweep'
    (K5m, 16 lin clusters), against the auto (K3) frame; K5m against its
    plain version on the path's camera rays and on 1M bounce-like rays,
    timed on the camera rays."""
    tag = "multiroom sweep"
    settings = mr_pt.settings.replace(intersector="sweep")
    pt = PathTracer(scene, settings, device=dev, lane_order=mr_pt.lane_order)
    ts = pt.scene
    phase(tag, f"{ts.clusters.lin.shape[0]} lin clusters of {cs.LIN}")
    zero_counts()
    pt.render(cam, frame_seed=0)
    torch.cuda.synchronize()
    launched = {k: v for k, v in counts().items() if v}
    mtd = settings.max_total_depth * settings.samples
    phase(tag, f"launches over one frame: {launched}")
    _expect(tag, launched, {"K5m": mtd, "K5m any-hit": mtd})
    ref = PathTracer(scene, mr_pt.settings, device=dev, lane_order=mr_pt.lane_order)
    ref.render(cam, frame_seed=0)
    _frame_vs(tag, "frame 0, intersector='sweep' (K5m) vs auto (K3)", pt.image(), ref.image())
    cam_o, cam_d = _camera_rays(camera_to_torch(cam, dev), settings, dev, pt.pixel_ids)
    nb = BOUNCE_RAYS
    bo, bd = _rays_in_rooms(nb, 9, dev)
    b_alive = torch.tensor(np.random.default_rng(10).random(nb) < 0.6, device=dev)
    chk = _sweep_kernel_checks(tag, [("camera rays, " + pt.lane_order, cam_o, cam_d, None),
                                     (f"{nb} bounce-like rays, 60% alive", bo, bd, b_alive)],
                               ts.clusters, _light0(ts))
    times = _time_sweep_passes(tag, chk["passes"],
                               f"the multiroom camera rays ({cam_o.x.shape[0]})")
    return {"launches": launched, "times": times, "errs": chk["errs"]}


def sweep_path_phase(scene, cam, dev, k4_first: np.ndarray, profile: bool) -> dict:
    """Path "soup:100000, sweep" (K5 with the sort and the row early-out):
    the first frame against the full-width frame and the 'cull' (K4) frame,
    8 timed frames with only K5 launching, and frame 0's test counter."""
    tag = "soup:100000 K5"
    pt = _first_frame_checks(tag, scene, cam, dev, intersector="sweep")
    _frame_vs(tag, "first frame, 'sweep' (K5) vs 'cull' (K4)", pt.image(), k4_first)
    launched, ms = _timed_frames(tag, pt, cam)
    mtd = pt.settings.max_total_depth * pt.settings.samples
    _expect(tag, launched, {"K5": FRAMES * mtd, "K5 any-hit": FRAMES * mtd})
    res = trace_rays(pt.scene, camera_to_torch(cam, dev), pt.settings, pt.pixel_ids, 0,
                     with_stats=True, max_leaf=pt.max_leaf)
    n_tests = int(res.heat_tests.sum())
    n_rays = int(res.n_path_rays)
    phase(tag, f"frame 0 counter (the faces the rows' verdicts ask for, both passes, "
               f"early-out savings not subtracted): {n_tests} ray-face tests, "
               f"{n_tests / n_rays:.1f} a path segment")
    if not n_tests > 0:
        raise AssertionError(f"{tag}: empty test counter")
    if profile:
        profile_phase(tag, pt, cam)
    return {"pt": pt, "launches": launched, "ms_frame": ms, "tests": n_tests}


def sweep_kernel_phase(dev, pt: PathTracer, cam) -> dict:
    """K5 against its plain version on all the path's camera rays (in its
    lane order) and on bounce-like rays with an alive mask and NEE; times
    of K5's passes, of the wrapper and of its plain version on the camera
    rays."""
    tag = "sweep kernels"
    ts = pt.scene
    clusters, l0 = ts.clusters, _light0(ts)
    cam_o, cam_d = _camera_rays(camera_to_torch(cam, dev), pt.settings, dev, pt.pixel_ids)
    n, nb = cam_o.x.shape[0], BOUNCE_RAYS
    bo, bd = _rays_in_soup(nb, 11, dev)
    b_alive = torch.tensor(np.random.default_rng(12).random(nb) < 0.6, device=dev)
    t0 = time.perf_counter()
    chk = _sweep_kernel_checks(tag, [(f"all {n} camera rays, {pt.lane_order}", cam_o, cam_d,
                                      None),
                                     (f"{nb} bounce-like rays, 60% alive", bo, bd, b_alive)],
                               clusters, l0)
    phase(tag, f"both comparisons with the plain version took "
               f"{time.perf_counter() - t0:.1f} s")
    what = f"all {n} camera rays x {ts.tris.mtl.shape[0]} faces"
    times = _time_sweep_passes(tag, chk["passes"], what)
    times["K5 wrapper"] = (
        _time_ms(lambda: cs.intersect_sweep(cam_o, cam_d, clusters, light_pos=l0), 5),
        _time_ms(lambda: cs.intersect_sweep_plain(cam_o, cam_d, clusters, light_pos=l0), 1))
    phase(tag, f"on {what}: wrapper (sort, lists, both passes) "
               f"{times['K5 wrapper'][0]:.4f} ms, plain {times['K5 wrapper'][1]:.4f} ms")
    return {"times": times, "errs": chk["errs"]}


# ------------------------------------------------------------ tree walks --

def _frame_vs(tag: str, what: str, img: np.ndarray, ref: np.ndarray) -> float:
    """At least 99% of pixels within 1e-3, no NaN; returns the share."""
    d = np.abs(img - ref).max(axis=-1)
    within = float((d <= 1e-3).mean())
    phase(tag, f"{what}: {within:.4%} of pixels within 1e-3, max |diff| {d.max():.3g}, means "
               f"{img.mean():.6f} / {ref.mean():.6f}")
    if within < 0.99 or np.isnan(img).any():
        raise AssertionError(f"{tag}: {what}: only {within:.4%} of pixels within 1e-3")
    return within


def tree_oracle_phase(scene, cam, dev, size: int = 64) -> None:
    """The card's 64² frames through K7 ('pallas_bvh_hbm'), K8 ('bvh'), the
    forest ('pallas_bvh_forest') and K5 ('sweep') against one frame of the
    port's CPU path through 'bvh': the walks' three plain versions are one
    function (the per-ray walk with the classic Moller-Trumbore), and every
    intersector returns the same faces, so no plain K5 frame is needed on
    the CPU."""
    t0 = time.perf_counter()
    host = PathTracer(scene, bench_settings(size, intersector="bvh"), device="cpu",
                      lane_order="scanline")
    host.render(cam, frame_seed=5)
    ref = host.image()
    phase("tree oracle", f"soup:100000 {size}² CPU frame through 'bvh' (the plain walk) in "
                         f"{time.perf_counter() - t0:.1f} s")
    for mode in ("pallas_bvh_hbm", "bvh", "pallas_bvh_forest", "sweep"):
        pt = PathTracer(scene, bench_settings(size, compact_schedule="auto", intersector=mode),
                        device=dev)
        pt.render(cam, frame_seed=5)
        _frame_vs("tree oracle", f"{size}² card frame through {mode!r} vs the CPU path",
                  pt.image(), ref)


def _one_frame_launches(tag: str, pt: PathTracer, cam, seed: int = 1) -> dict:
    """The launch counts of one more frame of ``pt``."""
    zero_counts()
    pt.render(cam, frame_seed=seed)
    torch.cuda.synchronize()
    launched = {k: v for k, v in counts().items() if v}
    phase(tag, f"launches over one frame: {launched}")
    return launched


def eager_frame(pt: PathTracer, cam, seed: int):
    """One frame of ``pt`` (its scene, settings, lanes and accumulator) by
    the eager ``render_frame``, not folded into ``pt``'s accumulator: the
    frame step that ``PathTracer.render`` replays from a CUDA graph, run op
    by op, so that a recorder swapped into a wrapper sees its calls.
    Returns the new ``FrameState``."""
    with torch.no_grad():
        return render_frame(pt.scene, camera_to_torch(cam, pt.device), pt.settings, pt.state,
                            pt.pixel_ids, seed, max_leaf=pt.max_leaf)


def _searches(launched: dict) -> dict:
    """The launches of ``launched`` other than the frame's kernels: the
    shading (K11, K12), which every forward frame on the card launches,
    and compaction (K13, K14), which every frame with a schedule launches,
    with their backward (``shade_phase``, the paths and the graph phase
    hold their counts)."""
    return {k: v for k, v in launched.items() if v and k not in FRAME_KERNELS}


def _expect(tag: str, launched: dict, expect: dict) -> None:
    """``launched`` is ``expect`` and no other; where ``expect`` names none
    of the frame's kernels, its search kernels are, and the shading and
    compaction launches are printed."""
    shading = {k: launched[k] for k in FRAME_KERNELS if launched.get(k)}
    got = {k: v for k, v in launched.items() if v}
    if not any(k in FRAME_KERNELS for k in expect):
        phase(tag, f"shading launches: {shading or 'none'}")
        got = _searches(got)
    if got != expect:
        raise AssertionError(f"{tag}: expected launches {expect} and no other, got {got}")


def tree_path_phase(scene, cam, dev, k4_first: np.ndarray, profile: bool) -> dict:
    """Paths "soup:100000, pallas_bvh_hbm" (K7, timed), "..., K7 NEE off",
    "soup:100000, bvh" (K8, timed, with the frame's counters) and
    "soup:100000, forest" (K6's chain, one frame), each first frame against
    the 'cull' (K4) frame."""
    out = {}
    mtd = bench_settings(SIZE).max_total_depth
    tag = "soup:100000 K7"
    pt = _first_frame_checks(tag, scene, cam, dev, intersector="pallas_bvh_hbm")
    _frame_vs(tag, "first frame, 'pallas_bvh_hbm' (K7) vs 'cull' (K4)", pt.image(), k4_first)
    launched, ms = _timed_frames(tag, pt, cam)
    _expect(tag, launched, {"K7 NEE": FRAMES * mtd})
    if profile:
        profile_phase(tag, pt, cam)
    out["k7"] = {"pt": pt, "launches": launched, "ms_frame": ms}
    off = PathTracer(scene, bench_settings(SIZE, shadow_rays=0, intersector="pallas_bvh_hbm"),
                     device=dev, lane_order="scanline")
    out["k7 off"] = _one_frame_launches("soup:100000 K7, NEE off", off, cam, 0)
    _expect("K7, NEE off", out["k7 off"], {"K7 nearest": mtd})
    del off

    tag = "soup:100000 K8"
    pt8 = _first_frame_checks(tag, scene, cam, dev, intersector="bvh")
    _frame_vs(tag, "first frame, 'bvh' (K8) vs 'cull' (K4)", pt8.image(), k4_first)
    launched, ms = _timed_frames(tag, pt8, cam)
    _expect(tag, launched, {"K8": FRAMES * mtd, "K8 any-hit": FRAMES * mtd})
    _shade_pattern(tag, launched, FRAMES, pt8.settings)
    res = trace_rays(pt8.scene, camera_to_torch(cam, dev), pt8.settings, pt8.pixel_ids, 0,
                     with_stats=True, max_leaf=pt8.max_leaf)
    n_tests, n_visits = int(res.heat_tests.sum()), int(res.heat_visits.sum())
    phase(tag, f"frame 0 counters (path rays; shadow walks are not counted, as in the JAX "
               f"package): {n_tests} ray-face tests, {n_visits} node visits, "
               f"{n_tests / int(res.n_path_rays):.1f} tests and "
               f"{n_visits / int(res.n_path_rays):.1f} visits a path segment")
    if not (n_tests > 0 and n_visits > 0):
        raise AssertionError(f"{tag}: empty counters")
    if profile:
        profile_phase(tag, pt8, cam)
    out["k8"] = {"launches": launched, "ms_frame": ms, "tests": n_tests, "visits": n_visits,
                 "shadow": shadow_leg_phase(tag, pt8, cam)}
    del pt8

    tag = "soup:100000 forest"
    ptf = _first_frame_checks(tag, scene, cam, dev, intersector="pallas_bvh_forest")
    _frame_vs(tag, "first frame, 'pallas_bvh_forest' (K6 chain) vs 'cull' (K4)", ptf.image(),
              k4_first)
    if ptf.scene.forest.count < 2:
        raise AssertionError(f"{tag}: the forest must have several sub-trees")
    launched = _one_frame_launches(tag, ptf, cam)
    # sub-tree 0, then the seeded chain over the others: one launch a pass
    _expect(tag, launched, {"K6 nearest": mtd, "K6 seeded": mtd,
                            "K6 any-hit": mtd, "K6 seeded any-hit": mtd})
    out["forest"] = {"launches": launched}
    return out


def _old_shadow_form(w, tris):
    """The shadow leg as it was before K8's any-hit instance, on the rays
    of the any-hit walk ``w``: the nearest search of ``intersect_scene``
    on every lane of the bounce, then t < t_light."""
    t_sh = tt.intersect_scene(w.o, w.d, tris, mode="bvh", bvh=w.tree, max_leaf=w.max_leaf)[0]
    return t_sh < w.t_limit


def shadow_leg_phase(tag: str, pt: PathTracer, cam) -> dict:
    """One more 'bvh' frame's shadow walks (K8 any-hit), recorded: each
    replayed by the kernel and by the plain version, bitwise, and held to
    the old form on every lane that casts a shadow ray; the leg's time in
    both forms (the integrator's ``occluded_scene`` and the old form's
    intersect_scene, 3 calls each) and the kernel's in both (the old form:
    K8 nearest on every lane). Returns bounce 0's walk checked and timed
    (the kernel row)."""
    tris = pt.scene.tris
    shadow = [w for w in _recorded(lambda: eager_frame(pt, cam, FRAMES + 3))
              if w.kernel == "K8 any-hit"]
    if len(shadow) != pt.settings.max_total_depth:
        raise AssertionError(f"{tag}: {len(shadow)} shadow walks in a frame")
    casting = occluded = 0
    ms = {"new leg": 0.0, "old leg": 0.0, "new kernel": 0.0, "old kernel": 0.0}
    for w in shadow:
        def leg(w=w):
            return tt.occluded_scene(w.o, w.d, w.t_limit, tris, mode="bvh", alive=w.alive,
                                     bvh=w.tree, max_leaf=w.max_leaf)
        new = leg()
        old = _old_shadow_form(w, tris)
        if not torch.equal(new[w.alive], old[w.alive]) or bool(new[~w.alive].any()):
            raise AssertionError(f"{tag}: the any-hit bit differs from the old form's on "
                                 f"{int((new != old)[w.alive].sum())} casting lanes")
        casting += int(w.alive.sum())
        occluded += int(new.sum())
        old_w = w._replace(kernel="K8", alive=None, t_limit=None,
                           order=cb.ray_order(w.o, w.d, w.tree))
        ms["new leg"] += _time_ms(leg, 3)
        ms["old leg"] += _time_ms(lambda: _old_shadow_form(w, tris), 3)
        ms["new kernel"] += _time_ms(lambda: cb._run_kernel(w), 3)
        ms["old kernel"] += _time_ms(lambda: cb._run_kernel(old_w), 3)
    lanes = sum(w.o.x.shape[0] for w in shadow)
    phase(tag, f"one frame's {len(shadow)} shadow walks: {lanes} lanes, {casting} cast a "
               f"shadow ray, {occluded} occluded; the any-hit bit equals the old form's "
               f"t < t_light on every casting lane; ms over the frame: "
               + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    res = _check_walks(tag, shadow[:1], "bounce 0's recorded shadow rays", True)
    _check_walks(tag, shadow[1:], "bounces 1-7's recorded shadow rays", True)
    return res


def soup10k_phase(dev) -> dict:
    """Path "soup:10000, pallas_bvh" (bench.py --scene soup:10000: 10,000
    faces, 2-face leaves, 11,953 nodes: the single-tree packet walk K6
    with NEE): one 1024² frame against its auto (K3) frame."""
    tag = "soup:10000 K6"
    scene, cam = load_scene("soup:10000")[:2]
    phase(tag, f"{scene.tris.count} faces, {scene.bvh.count} nodes; packet_fits "
               f"{cb.packet_fits(scene.bvh, scene.tris)}")
    auto = PathTracer(scene, bench_settings(SIZE, compact_schedule="auto"), device=dev)
    auto.render(cam, frame_seed=0)
    pt = _first_frame_checks(tag, scene, cam, dev, intersector="pallas_bvh")
    _frame_vs(tag, "first frame, 'pallas_bvh' (K6) vs auto (K3)", pt.image(), auto.image())
    launched = _one_frame_launches(tag, pt, cam)
    _expect(tag, launched, {"K6 NEE": pt.settings.max_total_depth})
    return {"pt": pt, "cam": cam, "launches": launched}


def _recorded(call) -> list:
    """The tree walks ``call`` launches (``cuda_bvh.run``'s arguments)."""
    walks = []
    real = cb.run

    def record(w):
        walks.append(w)
        return real(w)

    cb.run = record
    try:
        call()
    finally:
        cb.run = real
    return walks


def _walk_bound(w, work: list, uv: list) -> tuple:
    """Bound of one walk: the per-ray walk's node steps and leaf-face tests
    on these rays (what the plain version counted, both legs of NEE: each
    hit leaf's faces whole, and on an any-hit walk those up to and
    including the occluding face, where it stops; summed over a seeded
    chain's sub-trees), t for every test and u and v only where t can
    change the result (``uv``: ``cuda_bvh.uv_counts`` of each leg, as K1's
    bound counts them); bytes: the rays, the per-ray inputs and outputs,
    each once, the tree's nodes (9 words each; every sub-tree's for a
    chain) and its faces (9 words). Returns (that bound, tests, visits, u-v
    tests, the bound with the whole test charged on every face)."""
    tests = sum(int(t.sum()) for t, _ in work)
    visits = sum(int(v.sum()) for _, v in work)
    uv_tests = sum(int(u.sum()) for u in uv)
    n = w.o.x.shape[0]
    per_ray = 24 + sum(a.element_size() for a in (w.alive, w.order, w.t_limit, w.t_seed,
                                                  w.f_seed, w.occ_seed) if a is not None)
    per_ray += 1 if w.t_limit is not None else 8 + (1 if w.light is not None else 0)
    per_ray += 8 if w.with_counts else 0
    nodes = w.tree.trees.exit.numel() if isinstance(w.tree, ForestTables) else w.tree.count
    nbytes = per_ray * n + 36 * nodes + 36 * w.faces.shape[1]
    ops = OPS_SLAB * visits + OPS_CLASSIC_T * tests + OPS_CLASSIC_UV * uv_tests
    return (_bound(ops, nbytes), tests, visits, uv_tests,
            _bound(OPS_SLAB * visits + OPS_CLASSIC * tests, nbytes))


def _check_walks(tag: str, walks: list, what: str, timed: bool) -> dict:
    """Each recorded walk replayed by its kernel and by the plain version,
    bitwise; per instance, summed over its walks: largest |t| error and,
    ``timed``, kernel ms (CUDA events, 3 launches each), plain ms (one run,
    with the walk's counts) and bound."""
    res = {}
    for w in walks:
        work, uv = [], [] if timed else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = cb._run_plain(w, work, uv)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = cb._run_kernel(w)
        torch.cuda.synchronize()
        _equal_or_raise(f"{w.kernel} on {what}", got, ref)
        err = 0.0 if w.t_limit is not None else _max_err(got[0], ref[0])
        ms = _time_ms(lambda: cb._run_kernel(w), 3) if timed else None
        (b_ms, b_by), tests, visits, uv_tests, whole = _walk_bound(w, work, uv or [])
        r = res.setdefault(w.kernel, {"walks": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                      "bound_by": b_by, "err": 0.0, "tests": 0, "visits": 0,
                                      "uv_tests": 0, "whole_test_bound_ms": 0.0,
                                      "shadow_visits": 0})
        r["walks"] += 1
        r["plain_ms"] += plain_ms
        r["bound_ms"] += b_ms
        r["whole_test_bound_ms"] += whole[0]
        r["uv_tests"] += uv_tests
        r["ms"] = r["ms"] + ms if timed else None
        r["err"] = max(r["err"], err)
        r["tests"] += tests
        r["visits"] += visits
        if w.light is not None:  # NEE: the nearest leg's walk, then the shadow leg's
            r["shadow_visits"] += int(work[-1][1].sum())
    for name, r in res.items():
        n = walks[0].o.x.shape[0]
        legs = (f" ({r['shadow_visits'] / n:.1f} of them on the shadow leg)"
                if r["shadow_visits"] else "")
        bound = (f", {r['uv_tests'] / n:.1f} of them whose t can change the result; kernel "
                 f"{r['ms']:.4f} ms; plain {r['plain_ms']:.1f} ms; bound {r['bound_ms']:.4f} ms "
                 f"({r['bound_by']}; the whole test on every face: "
                 f"{r['whole_test_bound_ms']:.4f} ms)" if timed else "")
        phase(tag, f"{name} on {what} ({r['walks']} launch(es)): equal to the plain version "
                   f"bitwise; {r['visits'] / n:.1f} node steps{legs} and {r['tests'] / n:.1f} "
                   f"face tests a ray{bound}")
    return res


def tree_kernel_phase(dev, pt, cam, pt10k, cam10k) -> dict:
    """K7 and K8 against their plain versions, bitwise, on all 1M camera
    rays of the K7 path (its lane order) and on 1M bounce-like rays with an
    alive mask; the forest's K6 chain on the camera rays; K6's single-tree
    instances on soup:10000's camera rays; K8 also against
    ``intersect_bvh_chunked``. Times, plain times and bounds on the camera
    rays."""
    tag = "tree kernels"
    ts = pt.scene
    bvh, tris, l0 = ts.bvh, ts.tris, _light0(ts)
    ml = pt.max_leaf
    cam_o, cam_d = _camera_rays(camera_to_torch(cam, dev), pt.settings, dev, pt.pixel_ids)
    n = cam_o.x.shape[0]
    t0 = time.perf_counter()
    cam_walks = _recorded(lambda: (
        cb.intersect_bvh_packet_hbm(cam_o, cam_d, bvh, tris, ml, light_pos=l0),
        cb.intersect_bvh_packet_hbm(cam_o, cam_d, bvh, tris, ml),
        cb.intersect_bvh_walk(cam_o, cam_d, bvh, tris, ml),
        cb.intersect_bvh_forest(cam_o, cam_d, ts.forest, bvh, light_pos=l0)))
    res = _check_walks(tag, cam_walks, f"all {n} soup:100000 camera rays, {pt.lane_order}", True)
    t_cam = torch.tensor(np.random.default_rng(9).uniform(0.0, 6.0, n), dtype=torch.float32,
                         device=dev)
    t_cam[::16], t_cam[1::16] = 0.0, float("inf")
    _check_walks(tag, _recorded(lambda: cb.occluded_bvh_walk(
        cam_o, cam_d, t_cam, bvh, tris, ml, with_counts=True)),
        f"all {n} soup:100000 camera rays, t_limit 0, +inf and in [0, 6)", False)
    got = cb.intersect_bvh_walk(cam_o, cam_d, bvh, tris, ml, with_counts=True)
    ref = tt.intersect_bvh_chunked(cam_o, cam_d, bvh, tris, ml, with_counts=True)
    _equal_or_raise("K8 vs intersect_bvh_chunked", got, ref)
    phase(tag, "K8 with counters equals intersect_bvh_chunked (sorted, 8,192-ray chunks) "
               "bitwise on the camera rays")
    nb = BOUNCE_RAYS
    bo, bd = _rays_in_soup(nb, 7, dev)
    alive = torch.tensor(np.random.default_rng(8).random(nb) < 0.6, device=dev)
    t_b = torch.tensor(np.random.default_rng(10).uniform(0.0, 2.0, nb), dtype=torch.float32,
                       device=dev)
    _check_walks(tag, _recorded(lambda: (
        cb.intersect_bvh_packet_hbm(bo, bd, bvh, tris, ml, light_pos=l0, alive=alive),
        cb.intersect_bvh_walk(bo, bd, bvh, tris, ml, alive=alive, with_counts=True),
        cb.occluded_bvh_walk(bo, bd, t_b, bvh, tris, ml, alive=alive, with_counts=True),
        cb.intersect_bvh_forest(bo, bd, ts.forest, bvh, light_pos=l0, alive=alive))),
        f"{nb} bounce-like rays, 60% alive", False)
    t10 = pt10k.scene
    o10, d10 = _camera_rays(camera_to_torch(cam10k, dev), pt10k.settings, dev, pt10k.pixel_ids)
    res.update(_check_walks(tag, _recorded(lambda: (
        cb.intersect_bvh_packet(o10, d10, t10.bvh, t10.tris, pt10k.max_leaf,
                                light_pos=_light0(t10)),)),
        f"all {o10.x.shape[0]} soup:10000 camera rays", True))
    phase(tag, f"all comparisons and timings took {time.perf_counter() - t0:.1f} s")
    return res



# ------------------------------------------------------------------- app --

# Where the app phase's CLI runs write (git-ignored, emptied at the start).
APP_DIR = Path(__file__).resolve().parent / "build" / "pbr_tpu_torch" / "app"
FIT_STEPS, FIT_SIZE, VIEW_SIZE = 60, 64, 256


def _cli(tag: str, argv: list, dev) -> tuple:
    """``app.main(argv)`` on ``dev``, in-process, with the launch counts set
    to 0 just before it and read just after; returns (its result, the
    launches, seconds)."""
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    res = app.main([*argv, "--device", str(dev)])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launched = {k: v for k, v in counts().items() if v}
    phase(tag, f"app {' '.join(argv)}: {sec:.3f} s, launches {launched}")
    return res, launched, sec


def app_render_phase(cam, dev, size: int = SIZE) -> dict:
    """``render`` on the Cornell box (FRAMES frames with --stats --heatmap
    --depth-out --checkpoint), then one resumed frame with --denoise, then
    ``render --scene multiroom``."""
    tag = "app render"
    shutil.rmtree(APP_DIR, ignore_errors=True)
    APP_DIR.mkdir(parents=True)
    png = {k: str(APP_DIR / f"{k}.png") for k in ("cornell", "depth", "heat", "resumed",
                                                   "multiroom")}
    ck = str(APP_DIR / "checkpoint")
    common = ["render", "--scene", "cornell", "--size", str(size)]
    res, launched, _ = _cli(tag, [*common, "--frames", str(FRAMES), "--out", png["cornell"],
                                  "--depth-out", png["depth"], "--heatmap", png["heat"],
                                  "--checkpoint", ck, "--stats"], dev)
    pt = res["tracer"]
    depth = pt.settings.max_total_depth
    # K1 once a bounce: each frame, the first frame's two lane-order probes
    # and the heatmap's full-width trace.
    _expect(tag, launched, {"K1": depth * (FRAMES + 3)})
    for k in ("cornell", "depth", "heat"):
        shape = read_png(png[k]).shape
        if shape != (size, size, 3):
            raise AssertionError(f"{tag}: {png[k]} is {shape}")
    # The same frames through PathTracer: the CLI's scene (with its BVH:
    # the config's accel_struct) and settings.
    scene, objd = scene_from_text(*cornell_box())
    settings = apply_scene_constants(RenderSettings(width=size, height=size, shadow_rays=1,
                                                    compact_schedule="auto"), objd)
    ref = PathTracer(scene, settings, device=dev)
    for i in range(FRAMES):
        ref.render(cam, frame_seed=i)
    n_diff = int((res["image"] != ref.image()).any(axis=-1).sum())
    phase(tag, f"CLI image vs PathTracer frames 0-{FRAMES - 1}: {n_diff} pixels differ")
    if n_diff:
        _frame_vs(tag, "CLI image vs PathTracer", res["image"], ref.image())
    phase(tag, f"{size}² Cornell: {res['ms_frame']:.3f} ms/frame (host clock over "
               f"{FRAMES - 1} frames, synchronised)")

    res2, launched2, _ = _cli(tag, [*common, "--frames", "1", "--out", png["resumed"],
                                    "--checkpoint", ck, "--denoise", "--stats"], dev)
    n = res2["tracer"].sample_count
    if n != FRAMES + 1 or not np.isfinite(res2["image"]).all():
        raise AssertionError(f"{tag}: resumed sample_count {n}, expected {FRAMES + 1}")
    # The denoiser's feature pass is one nearest-only sweep (K1').
    _expect(tag + " resumed", launched2, {"K1": depth * 3, "K1'": 1})
    denoise_ms = {row[0]: row[2] for row in res2["timers"].rows()}["denoise"]
    phase(tag, f"resumed at sample_count {n}; {size}² denoise (features + filter) "
               f"{denoise_ms:.3f} ms")

    res3, launched3, _ = _cli(tag, ["render", "--scene", "multiroom", "--size", str(size),
                                    "--frames", "2", "--out", png["multiroom"]], dev)
    depth3 = res3["tracer"].settings.max_total_depth
    # The CLI renders multiroom without NEE (shadow_rays 0, the config's).
    _expect(tag + " multiroom", launched3, {"K3": depth3 * (2 + 2)})
    if read_png(png["multiroom"]).shape != (size, size, 3):
        raise AssertionError(f"{tag}: multiroom image has the wrong size")
    return {"ms_frame": res["ms_frame"], "denoise_ms": denoise_ms,
            "multiroom_ms_frame": res3["ms_frame"]}


def app_denoise_phase(scene, cam, dev, size: int = 128) -> None:
    """The denoiser on the card (first_hit_features + noise_filter) against
    the port's CPU path on the same noisy frame."""
    host = PathTracer(scene, bench_settings(size), device="cpu", lane_order="scanline")
    host.render(cam, frame_seed=3)
    noisy = np.ascontiguousarray(host.image()[::-1])  # pixel-row order
    out = {}
    for dv in (dev, "cpu"):
        feats = first_hit_features(to_torch(scene, dv), camera_to_torch(cam, dv),
                                   bench_settings(size))
        out[str(dv)] = noise_filter(torch.tensor(noisy, device=dv), *feats).cpu().numpy()
    _frame_vs("app denoise", f"{size}² features + filter, card vs CPU", out[str(dev)],
              out["cpu"])


def _fit_shading(tag: str, launched: dict, settings: RenderSettings, steps: int,
                 search: str) -> int:
    """``fit``'s shading launches, from its search's (``search`` once a
    bounce on every frame): K11 once a sample and the fused K12 once a
    bounce of every frame (the target frame, the loss frames of the line
    search and the end run under ``no_grad``, and the ``steps``
    value_and_grad frames, which autograd records with the albedos
    requiring grad), and K12 bwd once a bounce of those ``steps`` frames;
    no K11 bwd (the camera is no variable of the fit). Raises otherwise;
    returns the frames."""
    bounces = settings.samples * settings.max_total_depth
    frames, rest = divmod(launched.get(search, 0), bounces)
    want = {"K11": settings.samples * frames, "K12": bounces * frames, "K12 pre": 0,
            "K12 post": 0, "K11 bwd": 0, "K12 bwd": bounces * steps}
    got = {k: launched.get(k, 0) for k in SHADE_KERNELS}
    if rest or frames < 2 * steps + 2 or got != want:
        raise AssertionError(f"{tag}: {steps} steps launched {launched}: expected a whole "
                             f"number of frames, at least {2 * steps + 2}, and the shading "
                             f"{want} of that many")
    return frames


def app_fit_phase(dev, size: int = FIT_SIZE, steps: int = FIT_STEPS, big: int = SIZE) -> dict:
    """``fit`` on the Cornell box (it must converge), then ``fit --scene
    multiroom`` at full width for STEPS steps, with its peak memory."""
    tag = "app fit"
    res, launched, _ = _cli(tag, ["fit", "--scene", "cornell", "--size", str(size), "--steps",
                                  str(steps)], dev)
    losses = res["losses"] + [res["final_loss"]]
    rises = [i for i, (a, b) in enumerate(zip(losses, losses[1:])) if b > a]
    phase(tag, f"{size}² Cornell, {steps} steps: loss {losses[0]:.6f} -> {res['final_loss']:.6f} "
               f"({res['final_loss'] / losses[0]:.4f} of the first), max albedo error "
               f"{res['kd_err']:.4f}, {sum(res['accepted'])} steps accepted, "
               f"{res['ms_step']:.3f} ms/step")
    if set(_searches(launched)) != {"K1"}:
        raise AssertionError(f"{tag}: expected only K1 launches, got {launched}")
    frames = _fit_shading(tag, launched, res["settings"], steps, "K1")
    if res["final_loss"] > 0.25 * losses[0] or res["kd_err"] > 0.1 or rises:
        raise AssertionError(f"{tag}: no convergence (rises at steps {rises})")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res2, launched2, _ = _cli(tag, ["fit", "--scene", "multiroom", "--size", str(big),
                                    "--steps", str(STEPS)], dev)
    peak = torch.cuda.max_memory_allocated() - base
    phase(tag, f"{big}² multiroom, {STEPS} steps: {res2['ms_step']:.3f} ms/step, peak memory "
               f"{peak / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB held before, loss "
               f"{res2['losses'][0]:.6f} -> {res2['final_loss']:.6f}")
    if set(_searches(launched2)) != {"K3", "K3 any-hit"} \
            or launched2["K3"] != launched2["K3 any-hit"]:
        raise AssertionError(f"{tag}: expected K3's two instances alike, got {launched2}")
    frames2 = _fit_shading(tag, launched2, res2["settings"], STEPS, "K3")
    if not np.isfinite(res2["final_loss"]) or res2["final_loss"] > res2["losses"][0]:
        raise AssertionError(f"{tag}: multiroom loss rose")
    return {"ms_step": res["ms_step"], "loss_first": losses[0], "loss_final": res["final_loss"],
            "kd_err": res["kd_err"], "multiroom_ms_step": res2["ms_step"],
            "multiroom_peak_mib": peak / 2**20, "frames": frames, "multiroom_frames": frames2}


def app_gemm_phase(scene, cam, dev, k1: dict, k1_ms: float, size: int = SIZE) -> dict:
    """The ``gemm`` mode on the Cornell box's camera rays against K1's
    nearest instance (faces and t), timed, with its chunk and peak memory;
    then one frame through it against the K1 frame."""
    tag = "app gemm"
    o, d, tris = k1["o"], k1["d"], k1["tris"]
    t_k, f_k = ci.intersect_fused(o, d, tris)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_g, f_g = gi.intersect_gemm(o, d, tris)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    agree = f_g == f_k
    share = float(agree.float().mean())
    both = agree & torch.isfinite(t_k)
    t_bad = int(((t_g - t_k).abs() > 1e-4 + 1e-4 * t_k.abs())[both].sum())
    # The caller's TF32 setting changes nothing: the product runs in full
    # float32, and the setting comes back as it was.
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    try:
        matmul.allow_tf32 = True
        t_32, f_32 = gi.intersect_gemm(o, d, tris)
        restored = matmul.allow_tf32
    finally:
        matmul.allow_tf32 = saved
    if not (restored and torch.equal(t_32, t_g) and torch.equal(f_32, f_g)):
        raise AssertionError(f"{tag}: the caller's TF32 setting changed the product")
    ms = _time_ms(lambda: gi.intersect_gemm(o, d, tris), 5)
    feats, w = gi.ray_features(o, d), gi.triangle_coefficients(tris)
    with gi.full_float32():
        product_ms = _time_ms(lambda: feats @ w, 5)
    nf = int(tris.mtl.shape[0])
    phase(tag, f"{o.x.shape[0]} camera rays x {nf} faces: faces agree with K1' on {share:.4%}, "
               f"{t_bad} agreeing rays with t off by more than 1e-4, bitwise the same with "
               f"TF32 asked for; {ms:.4f} ms per call, of which the (B, 16) x (16, {4 * nf}) "
               f"product {product_ms:.4f} ms (K1' {k1_ms:.4f} ms), chunk {gi.chunk_rays(nf)} "
               f"rays, peak memory {peak / 2**20:.1f} MiB")
    if share <= 0.995 or t_bad:
        raise AssertionError(f"{tag}: gemm disagrees with K1")
    ref = PathTracer(scene, bench_settings(size), device=dev, lane_order="scanline")
    ref.render(cam, frame_seed=0)
    pt = PathTracer(scene, bench_settings(size, intersector="gemm"), device=dev,
                    lane_order="scanline")
    _expect(tag, _one_frame_launches(tag, pt, cam, seed=0), {})  # cuBLAS, no kernel of ours
    _frame_vs(tag, "a frame through 'gemm' vs K1", pt.image(), ref.image())
    return {"ms": ms, "product_ms": product_ms, "k1_nearest_ms": k1_ms,
            "chunk_rays": gi.chunk_rays(nf),
            "peak_mib": peak / 2**20, "faces_agree": share}


def app_view_phase(dev, size: int = VIEW_SIZE) -> dict:
    """``view`` with a key script: 'wasd' move the camera (4 restarts of
    the accumulation), 'l' toggles light mode, then 2 frames accumulate."""
    tag = "app view"
    v, launched, sec = _cli(tag, ["view", "--scene", "cornell", "--size", str(size), "--frames",
                                  "6", "--keys", "wasdl", "--no-draw"], dev)
    got = (v.frame, v._resets, v.tracer.sample_count, v.move_light)
    phase(tag, f"frames, restarts, sample_count, light mode: {got}; startup {v.startup}")
    if got != (6, 4, 3, True):
        raise AssertionError(f"{tag}: expected (6, 4, 3, True), got {got}")
    # K1 once a bounce: 6 frames, the two lane-order probes and the eager
    # frame of the warm-up's capture (undone), all at the viewer's start.
    _expect(tag, launched, {"K1": v.tracer.settings.max_total_depth * (6 + 3)})
    return {"s": sec}

# ----------------------------------------------------------------- Phong --

PHONG_ALPHA, PHONG_FRAMES = 0.8, 2
# The JAX package's threshold of the Phong dispatch (pbr_tpu/ops/
# phongtess.py:496): the Phong golden's reference, whose frames run K10
# whatever the band, and the CPU references' threshold.
PHONG_OLD_MIN_RAYS = 4096
# The denser sphere: 9,024 curved faces and the box's 34, 142 clusters of
# 64 (long candidate lists) and a deep tree.
PHONG_DENSE = dict(rings=48, segments=96)


def _graph_iters(fn) -> int:
    """Calls of ``fn`` a CUDA graph replay holds for ``k1_sweep.graph_ms``:
    about half a second of work, 1 to 20 calls."""
    ms = k1_sweep.time_once(fn)[0]
    return int(min(20, max(1, 500.0 / max(ms, 1e-3))))


def _registers(name: str) -> dict:
    """{function: registers} of the built library ``name``, as cuobjdump's
    resource usage gives them (``REG:N`` on the line after each function's
    mangled name); empty where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    lines = subprocess.run([tool, "--dump-resource-usage", str(ci.build(name))],
                           capture_output=True, text=True).stdout.splitlines()
    return {ln.split("Function", 1)[1].strip(" :"): int(nxt.split("REG:")[1].split()[0])
            for ln, nxt in zip(lines, lines[1:]) if "Function" in ln and "REG:" in nxt}


def k9_registers() -> str:
    """K9's two instances' registers (``_registers``)."""
    regs = _registers("phong_walk")
    inst = {"K9": "phong_walk_kernelILb0E", "K9 any-hit": "phong_walk_kernelILb1E"}
    return ", ".join(f"{k} {next((v for f, v in regs.items() if m in f), 'not read')}"
                     for k, m in inst.items())


def phong_walk_check(tag: str, what: str, o, d, ts) -> dict:
    """K9 against its plain version on the card, bitwise (t, face, u, v):
    the kernel's ms (its launch alone on the rays as given, replayed from a
    CUDA graph), the wrapper's (its checks and the launch), the plain
    version's, and the bound from the plain walk's work (node steps, flat
    and curved face tests)."""
    faces, ml = ts.phong_records, tt.leaf_bound(ts.bvh)
    got = cp.intersect_walk(o, d, ts.bvh, faces, PHONG_ALPHA)
    work = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = phongtess.intersect_bvh_phongtess(o, d, ts.bvh, None, PHONG_ALPHA, faces=faces,
                                            work=work)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    _equal_or_raise(f"{tag}: K9 on {what}", got, ref)
    launch = lambda: cp.walk_kernel(o, d, ts.bvh, faces, PHONG_ALPHA, ml, None, None)  # noqa: E731
    ms = k1_sweep.graph_ms(launch, _graph_iters(launch))
    wrapped = lambda: cp.intersect_walk(o, d, ts.bvh, faces, PHONG_ALPHA)  # noqa: E731
    wrapper_ms = k1_sweep.graph_ms(wrapped, _graph_iters(wrapped))
    n = o.x.shape[0]
    ops = (work["visits"] * cp.OPS_NODE + work["flat"] * cp.OPS_MT
           + work["curved"] * cp.OPS_PATCH + n * cp.OPS_RAY)
    nbytes = n * (24 + 16) + ts.bvh.count * 32 + faces.numel() * 4
    bound, by = _bound(ops, nbytes)
    hit = float((got[1] >= 0).float().mean())
    phase(tag, f"K9 on {what} ({n} rays, as given): bitwise its plain version (t, face, u, "
               f"v), hit {hit:.4f}; kernel {ms:.4f} ms, through the wrapper {wrapper_ms:.4f} "
               f"ms, plain {plain_ms:.1f} ms; {work['visits']} node steps, {work['flat']} flat "
               f"and {work['curved']} curved face tests; bound {bound:.4f} ms ({by})")
    return {"rays": n, "ms": ms,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "err": _max_err(got[0], ref[0]), **work}


def phong_any_hit_check(tag: str, what: str, o, d, t_limit, alive, ts) -> dict:
    """K9's any-hit instance against its plain version on the card,
    bitwise, and against the nearest search's bit
    (``intersect_scene_phongtess(...)[0] < t_limit``, the leg's old form on
    the card): the rays whose bits differ are counted, and any raises. The
    kernel's ms (its launch alone on the rays as given, replayed from a
    CUDA graph), the wrapper's, the plain version's, and the bound from
    the plain walk's work up to each ray's occluder (node steps x 25, flat
    tests x 51, curved x 578, rays x 65; bytes: 28 in and 1 out a ray, the
    tree's nodes and faces)."""
    faces, ml = ts.phong_records, tt.leaf_bound(ts.bvh)
    got = cp.occluded_walk(o, d, t_limit, ts.bvh, faces, PHONG_ALPHA, alive=alive)
    work = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = phongtess.occluded_bvh_phongtess(o, d, t_limit, ts.bvh, None, PHONG_ALPHA,
                                           faces=faces, alive=alive, work=work)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    _equal_or_raise(f"{tag}: K9 any-hit on {what}", got, ref)
    nearest = phongtess.intersect_scene_phongtess(o, d, ts.tris, PHONG_ALPHA, bvh=ts.bvh,
                                                  max_leaf=ml, alive=alive, faces=faces)[0]
    differ = int((got != (nearest < t_limit)).sum())
    if differ:
        raise AssertionError(f"{tag}: K9 any-hit on {what}: the bit differs from the nearest "
                             f"search's t < t_limit on {differ} rays")
    launch = lambda: cp.walk_kernel(o, d, ts.bvh, faces, PHONG_ALPHA, ml, alive, None,  # noqa
                                    t_limit)
    ms = k1_sweep.graph_ms(launch, _graph_iters(launch))
    wrapped = lambda: cp.occluded_walk(o, d, t_limit, ts.bvh, faces, PHONG_ALPHA,  # noqa: E731
                                       alive=alive)
    wrapper_ms = k1_sweep.graph_ms(wrapped, _graph_iters(wrapped))
    n = o.x.shape[0]
    ops = (work.get("visits", 0) * cp.OPS_NODE + work.get("flat", 0) * cp.OPS_MT
           + work.get("curved", 0) * cp.OPS_PATCH + n * cp.OPS_RAY)
    nbytes = n * (28 + 1) + ts.bvh.count * 32 + faces.numel() * 4
    bound, by = _bound(ops, nbytes)
    casting = n if alive is None else int(alive.sum())
    phase(tag, f"K9 any-hit on {what} ({n} rays, {casting} cast, {int(got.sum())} occluded, "
               f"as given): bitwise its plain version, and the nearest search's t < t_limit on "
               f"all but {differ} rays; kernel {ms:.4f} ms, through the wrapper "
               f"{wrapper_ms:.4f} ms, plain {plain_ms:.1f} ms; "
               f"{work.get('visits', 0)} node steps, {work.get('flat', 0)} flat and "
               f"{work.get('curved', 0)} curved face tests up to the occluders; bound "
               f"{bound:.4f} ms ({by})")
    return {"rays": n, "casting": casting, "ms": ms, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "err": 0.0,
            "differ": differ, **work}


def phong_clusters_check(tag: str, what: str, o, d, ts) -> dict:
    """K10 against its plain version on the card, bitwise (face, u, v): on
    the rays in K10's tile order (``sorted_lists``), with each tile's
    rounds, and on the rays as given (the results do not depend on the
    tiles). The kernel's ms (its launch alone over the sorted rays and
    their lists, replayed from a CUDA graph), the wrapper's (with the sort
    and the lists), the plain version's (on the sorted rays); rounds a tile
    of K10 and of the JAX loop's rule; two bounds: that of the tests K10
    runs (its active rays' faces and its slab tests: ``bound_ms``) and the
    yardstick (every real face of the rounds a tile runs under the JAX
    rule, on the tiles of the rays as given, against each live ray:
    ``bound_jax_ms``), both from ``cluster_work`` and ``cluster_tests``."""
    faces, cl = ts.phong_records, ts.clusters
    got = cp.intersect_clusters(o, d, cl, faces, PHONG_ALPHA, with_rounds=True)
    so, sd, _, order, lists = cp.sorted_lists(o, d, cl)
    stats, given = {}, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_s = phongtess.intersect_clusters_phongtess(so, sd, cl, None, PHONG_ALPHA, stats=stats,
                                                   faces=faces)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ref = tuple(torch.empty_like(a).index_copy_(0, order.long(), a) for a in ref_s)
    _equal_or_raise(f"{tag}: K10 on {what}", got[:3], ref)
    if not torch.equal(got[3], stats["per_tile"]):
        raise AssertionError(f"{tag}: K10 on {what}: rounds a tile differ from the plain "
                             f"version's on {int((got[3] != stats['per_tile']).sum())} tiles")
    ref_g = phongtess.intersect_clusters_phongtess(o, d, cl, None, PHONG_ALPHA, stats=given,
                                                   faces=faces)
    _equal_or_raise(f"{tag}: K10 on {what}, the plain version on the rays as given", got[:3],
                    ref_g)
    launch = lambda: cp.clusters_kernel(so, sd, faces, cl, lists, PHONG_ALPHA, None, order)  # noqa
    ms = k1_sweep.graph_ms(launch, _graph_iters(launch))
    wrapped = lambda: cp.intersect_clusters(o, d, cl, faces, PHONG_ALPHA)  # noqa: E731
    wrapper_ms = k1_sweep.graph_ms(wrapped, _graph_iters(wrapped))
    n, tiles = o.x.shape[0], got[3].shape[0]
    live = torch.arange(tiles * cp.TILE, device=o.x.device) < n
    lists_g = cp.candidate_lists(o, d, cl)
    work, work_g = cp.cluster_work(lists, stats), cp.cluster_work(lists_g, given)
    flat, curved = cp.cluster_tests(lists_g[0], work_g["jax_rounds"], live, faces, cl.size)
    _, _, flat_run, curved_run = cp.cluster_tests(lists[0], work["jax_rounds"], live, faces,
                                                  cl.size, active=stats["active"])
    nbytes = n * (24 + 12) + sum(a.numel() * 4 for a in lists) + faces.numel() * 4
    bound_jax, by_jax = _bound(flat * cp.OPS_MT + curved * cp.OPS_PATCH + n * cp.OPS_RAY,
                               nbytes)
    bound, by = _bound(work["slabs"] * cp.OPS_NODE + flat_run * cp.OPS_MT
                       + curved_run * cp.OPS_PATCH + n * cp.OPS_RAY,
                       nbytes + n * 4 + cl.count * 32)
    rounds, jax_rounds = got[3].float(), work_g["jax_rounds"].float()
    hit = float((got[0] >= 0).float().mean())
    phase(tag, f"K10 on {what} ({n} rays, {tiles} tiles, lists of {cl.count}): bitwise its "
               f"plain version (face, u, v) on the sorted rays, with the rounds a tile, and on "
               f"the rays as given; hit {hit:.4f}; rounds a tile mean "
               f"{float(rounds.mean()):.2f}, max {int(rounds.max())} (the JAX rule on the "
               f"rays as given: mean {float(jax_rounds.mean()):.2f}, max "
               f"{int(jax_rounds.max())}); kernel {ms:.4f} ms, with the sort and the lists "
               f"{wrapper_ms:.4f} ms, plain {plain_ms:.1f} ms; K10 ran {flat_run} flat and "
               f"{curved_run} curved face tests and {work['slabs']} slab tests, staged "
               f"{work['staged']} (tile, cluster) rounds: bound {bound:.4f} ms ({by}); the "
               f"JAX rule's {flat} flat and {curved} curved face tests: bound "
               f"{bound_jax:.4f} ms ({by_jax})")
    return {"rays": n, "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "bound_jax_ms": bound_jax,
            "bound_jax_by": by_jax, "err": _max_err(got[1], ref[1]),
            "tile_rounds": stats["tile_rounds"], "max_rounds": stats["rounds"], "tiles": tiles,
            "jax_tile_rounds": int(jax_rounds.sum()), "jax_max_rounds": int(jax_rounds.max()),
            "flat_tests": flat, "curved_tests": curved, "flat_run": flat_run,
            "curved_run": curved_run, "slab_tests": work["slabs"], "staged": work["staged"]}


def _recorded_searches(pt: PathTracer, cam, seed: int) -> list:
    """(kernel, rays, shadow rays) of each Phong search an eager frame of
    ``pt`` makes, in order (the wrappers swapped for recorders for the
    frame): shadow rays ``(o, d, t_limit, alive)``, copied, for K9's
    any-hit walks, else None."""
    calls = []
    real = {"K9": cp.intersect_walk, "K9 any-hit": cp.occluded_walk,
            "K10": cp.intersect_clusters}

    def recorder(name):
        def call(o, *a, **k):
            rays = None
            if name == "K9 any-hit":
                rays = (Vec3(*(c.clone() for c in o)), Vec3(*(c.clone() for c in a[0])),
                        a[1].clone(), None if k.get("alive") is None else k["alive"].clone())
            calls.append((name, o.x.shape[0], rays))
            return real[name](o, *a, **k)
        return call

    cp.intersect_walk, cp.occluded_walk, cp.intersect_clusters = (
        recorder(k) for k in ("K9", "K9 any-hit", "K10"))
    try:
        eager_frame(pt, cam, seed)
    finally:
        cp.intersect_walk, cp.occluded_walk, cp.intersect_clusters = (
            real[k] for k in ("K9", "K9 any-hit", "K10"))
    return calls


def _band_kernel(rays: int, shadow: bool = False) -> str:
    """The search the Phong dispatch takes for a pass of ``rays`` rays on a
    scene with clusters: a nearest pass, or with ``shadow`` a shadow leg
    (where the nearest pass would walk K9, its any-hit instance)."""
    big = phongtess.CLUSTER_MIN_RAYS
    if big is not None and rays >= big:
        return "K10"
    return "K9 any-hit" if shadow else "K9"


def phong_path(tag: str, scene, cam, dev) -> dict:
    """A Phong path at 1024² (bench.py's settings, alpha PHONG_ALPHA): the
    first frame, compacted, bitwise the full-width frame; the frame step's
    graph holds the band's search for each pass (``_band_kernel``: an eager
    frame's searches, recorded) and no other kernel of the port;
    PHONG_FRAMES replayed frames, timed, each bitwise the eager
    ``render_frame`` frame from the same state, which is timed too;
    the launches over the replays; one more replay under the profiler
    (launches and device ms a frame); the peak memory."""
    pt = _first_frame_checks(tag, scene, cam, dev, phong_tessellation=PHONG_ALPHA)
    first = pt.image()
    g = pt.graph
    if g is None or g.graph is None:
        raise AssertionError(f"{tag}: the Phong frame step was not captured")
    nodes = kernel_counts(g.kernels)
    # The recorder's copies of the shadow rays are not the path's memory:
    # none is held while the peak is read (the checks record them after).
    calls = [(k, n) for k, n, _ in _recorded_searches(pt, cam, 1)]
    # A bounce's nearest pass, then its shadow leg.
    wrong = [(k, n) for j, (k, n) in enumerate(calls) if k != _band_kernel(n, j % 2 == 1)]
    expect = {k: sum(1 for c, _ in calls if c == k) for k in ("K9", "K9 any-hit", "K10")}
    expect = {k: v for k, v in expect.items() if v}
    if wrong or _searches(nodes) != expect or not calls:
        raise AssertionError(f"{tag}: the graph's kernel nodes {nodes}, an eager frame's "
                             f"searches {calls} (K10 from {phongtess.CLUSTER_MIN_RAYS} rays, "
                             f"K9 and K9 any-hit below)")
    phase(tag, f"the frame step's graph: {g.stats()['nodes']} nodes, the port's kernels "
               f"{nodes}: an eager frame's searches by their rays {calls}")
    saved = _state_copy(pt.state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    got = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ms_graph = 0.0
    for i in range(1, 1 + PHONG_FRAMES):
        start.record()
        pt.render(cam, frame_seed=i)
        end.record()
        end.synchronize()
        ms_graph += start.elapsed_time(end) / PHONG_FRAMES
        got.append(_state_copy(pt.state))
    launched = {k: v for k, v in counts().items() if v}
    peak = torch.cuda.max_memory_allocated()
    _expect(f"{tag}, {PHONG_FRAMES} replays", launched,
            {k: PHONG_FRAMES * v for k, v in nodes.items()})
    state = FrameState(Vec3(*saved[:3]), saved[3], saved[4])
    ct = camera_to_torch(cam, dev)
    ms_eager = 0.0
    for i in range(1, 1 + PHONG_FRAMES):
        start.record()
        with torch.no_grad():
            state = render_frame(pt.scene, ct, pt.settings, state, pt.pixel_ids, i,
                                 max_leaf=pt.max_leaf)
        end.record()
        end.synchronize()
        ms_eager += start.elapsed_time(end) / PHONG_FRAMES
        bad = [j for j, (a, b) in enumerate(zip(got[i - 1], _state_copy(state)))
               if not torch.equal(a, b)]
        if bad:
            raise AssertionError(f"{tag}: replayed frame {i} differs from the eager frame in "
                                 f"state fields {bad}")
    img = pt.image()
    if not np.isfinite(img).all() or not 0.05 < float(img.mean()) < 5.0:
        raise AssertionError(f"{tag}: implausible image: mean {img.mean()}")
    n_launch, dev_ms, ours_ms, prof_wall = _device_launches(
        lambda: pt.render(cam, frame_seed=1 + PHONG_FRAMES))
    shadow = [r for k, _, r in _recorded_searches(pt, cam, 1) if k == "K9 any-hit"][:2]
    phase(tag, f"1024²: {PHONG_FRAMES} replayed frames bitwise the eager frames; ms/frame "
               f"graphed {ms_graph:.3f}, eager {ms_eager:.3f}; launches over the replays "
               f"{launched}; peak memory {peak / 2**20:.1f} MiB; one replay under the profiler "
               f"({prof_wall:.1f} ms): {n_launch} kernel launches, {dev_ms:.3f} ms of device "
               f"time, the port's kernels {ours_ms:.3f} ms")
    return {"pt": pt, "first": first, "launches": launched, "frames": PHONG_FRAMES,
            "shadow_rays": shadow,
            "ms_graph": ms_graph, "ms_eager": ms_eager, "launches_per_frame": n_launch,
            "graph_nodes": g.stats()["nodes"], "kernel_nodes": nodes,
            "device_ms_per_frame": dev_ms, "port_kernels_ms": ours_ms,
            "profiled_frame_ms": prof_wall, "peak_mib": peak / 2**20,
            "lane_order": pt.lane_order, "schedule": pt.settings.compact_schedule}


def phong_kernel_checks(tag: str, pt: PathTracer, cam, dev, shadow_rays: list) -> dict:
    """K9 on 4,095 of the path's camera rays, on all 1M of them (camera
    passes) and on 1M rays in the box (a bounce pass), and K10 on the 1M
    camera rays and the 1M rays in the box, each bitwise its plain version
    (``phong_walk_check``, ``phong_clusters_check``); K9 any-hit on the
    frame's recorded shadow rays of bounces 0 and 1 (``shadow_rays``) and
    on the 1M box rays with t_limit drawn around each ray's nearest t
    (``phong_any_hit_check``)."""
    ts = pt.scene
    cam_o, cam_d = _camera_rays(camera_to_torch(cam, dev), pt.settings, dev, pt.pixel_ids)
    box = _rays_in_box(BOUNCE_RAYS, 5, dev)
    cut = lambda v: Vec3(*(c[:PHONG_OLD_MIN_RAYS - 1].contiguous() for c in v))  # noqa: E731
    out = {"K9 4095": phong_walk_check(tag, "4,095 camera rays", cut(cam_o), cut(cam_d), ts),
           "K9 camera": phong_walk_check(tag, "the camera rays", cam_o, cam_d, ts),
           "K9 box": phong_walk_check(tag, "1M rays in the box", *box, ts)}
    for b, (o, d, t_limit, alive) in enumerate(shadow_rays):
        out[f"K9 any-hit {b}"] = phong_any_hit_check(
            tag, f"the frame's recorded shadow rays of bounce {b}", o, d, t_limit, alive, ts)
    t_box = cp.intersect_walk(*box, ts.bvh, ts.phong_records, PHONG_ALPHA)[0]
    scale = torch.tensor(np.random.default_rng(12).uniform(0.5, 1.5, BOUNCE_RAYS),
                         dtype=torch.float32, device=dev)
    t_lim = torch.where(torch.isfinite(t_box), t_box * scale, 10.0).contiguous()
    out["K9 any-hit box"] = phong_any_hit_check(
        tag, "1M rays in the box, t_limit in [0.5, 1.5) of the nearest t", *box, t_lim, None, ts)
    regs = k9_registers()
    phase(tag, f"K9's registers (cuobjdump): {regs}")
    out["K9 camera"]["registers"] = regs
    out["K10 camera"] = phong_clusters_check(tag, "the camera rays", cam_o, cam_d, ts)
    out["K10 box"] = phong_clusters_check(tag, "1M rays in the box", *box, ts)
    return out


def phong_golden_phase(tag: str, scene, cam, pt: PathTracer, dev) -> dict:
    """The Phong device golden: the 1024² first frame of ``pt`` (the band's
    threshold) against the same frame under the JAX package's threshold
    (PHONG_OLD_MIN_RAYS: K10 for every pass of 4,096 rays or more), at least
    99% of pixels within 1e-3, no NaN; that tracer's frames (its capture's
    eager frame and one replay) counted from zero, K10's launches under
    that threshold, and its replayed frame bitwise the eager
    ``render_frame`` frame from the same state; at 64² (every pass 4,096
    rays), the card's gradients under each threshold (``_grads_agree``)."""
    with phongtess.threshold(PHONG_OLD_MIN_RAYS):
        zero_counts()
        old = PathTracer(scene, pt.settings, device=dev, lane_order=pt.lane_order)
        old.render(cam, frame_seed=0)
        first = old.image()
        saved = _state_copy(old.state)
        old.render(cam, frame_seed=1)
        torch.cuda.synchronize()
        launched = {k: v for k, v in counts().items() if v}
        with torch.no_grad():
            state = render_frame(old.scene, camera_to_torch(cam, dev), old.settings,
                                 FrameState(Vec3(*saved[:3]), saved[3], saved[4]),
                                 old.pixel_ids, 1, max_leaf=old.max_leaf)
        bad = [j for j, (a, b) in enumerate(zip(_state_copy(old.state), _state_copy(state)))
               if not torch.equal(a, b)]
    if "K10" not in launched or set(_searches(launched)) - {"K9", "K9 any-hit", "K10"}:
        raise AssertionError(f"{tag}: the frames under {PHONG_OLD_MIN_RAYS} rays launched "
                             f"{launched}")
    if bad:
        raise AssertionError(f"{tag}: under {PHONG_OLD_MIN_RAYS} rays the replayed frame "
                             f"differs from the eager frame in state fields {bad}")
    ref = PathTracer(scene, pt.settings, device=dev, lane_order=pt.lane_order)
    ref.render(cam, frame_seed=0)
    within = _frame_vs(tag, f"first frame, CLUSTER_MIN_RAYS {phongtess.CLUSTER_MIN_RAYS} vs "
                            f"{PHONG_OLD_MIN_RAYS}", ref.image(), first)
    del old, ref
    small = bench_settings(64, phong_tessellation=PHONG_ALPHA)
    _grads_agree(tag, scene, cam, (dev, small), (dev, small, PHONG_OLD_MIN_RAYS),
                 f"CLUSTER_MIN_RAYS {phongtess.CLUSTER_MIN_RAYS} vs {PHONG_OLD_MIN_RAYS}")
    phase(tag, f"under {PHONG_OLD_MIN_RAYS} rays, a frame's capture and one replay launched "
               f"{launched}; the replayed frame bitwise the eager frame")
    return {"within": within, "launches": launched, "frames": 2}


def phong_fit_check(scene, cam, dev, size: int = 64) -> dict:
    """``fit``'s graphed steps (``app.fit_steps``) on the Phong scene at
    ``size``² (every pass of 4,096 rays: the band's search), bitwise the
    eager step at three points; that search launches and no other kernel of
    the port."""
    settings = RenderSettings().replace(width=size, height=size, shadow_rays=1, brdf=0,
                                        max_depth=2, max_added_depth=0,
                                        phong_tessellation=PHONG_ALPHA)
    zero_counts()
    out = _fit_steps_bitwise(f"Phong {size}²", app.fit_problem(scene, settings, cam, dev))
    launched = {k: v for k, v in counts().items() if v}
    want = {_band_kernel(size * size), _band_kernel(size * size, shadow=True)}
    if set(_searches(launched)) != want:
        raise AssertionError(f"fit on the Phong scene launched {launched}, not {want}")
    phase("phong", f"fit's graphed steps on the Phong scene at {size}² bitwise the eager "
                   f"step at 3 points; launches {launched}")
    return {**out, "launches": launched}


def phong_phase(cam, dev, size: int = SIZE) -> dict:
    """Path "phong": the Cornell box and a smooth sphere (562 faces, 9
    clusters of 64 over the curved-patch-inflated bounds) at alpha 0.8 with
    bench.py's settings, through kernels K10 and K9; then the same on the
    denser sphere (PHONG_DENSE: 9,058 faces, 142 clusters)."""
    tag = "phong"
    scene, _ = scene_from_text(*cornell_sphere(), use_bvh=True, phong_tess_alpha=PHONG_ALPHA)
    curved = int((~phongtess.face_is_flat(to_torch(scene, "cpu").tris)).sum())
    phase(tag, f"{scene.tris.count} faces ({curved} curved), {scene.clusters.bb_min.x.shape[0]} "
               f"clusters of {scene.clusters.size} (real and padding), BVH {scene.bvh.count} "
               f"nodes, alpha {PHONG_ALPHA}")
    kw = dict(phong_tessellation=PHONG_ALPHA)
    t0 = time.perf_counter()
    sec = {}

    def lap(what):
        nonlocal t0
        sec[what] = time.perf_counter() - t0
        t0 = time.perf_counter()

    # The CPU references take the plain cluster search for their 4,096-ray
    # passes: the plain walk, host-driven, takes about three times as long
    # on the CPU (tools/phong_bands.py --oracle).
    oracle_phase(tag, scene, cam, dev, size=64, host_min_rays=(PHONG_OLD_MIN_RAYS,), **kw)
    lap("64² frames")
    small = bench_settings(64, **kw)
    _grads_agree(tag, scene, cam, (dev, small), ("cpu", small, PHONG_OLD_MIN_RAYS),
                 "card vs CPU (its passes of 4,096 rays by the cluster search)")
    lap("64² gradients")
    path = phong_path(tag, scene, cam, dev)
    lap("1024² frames")
    passes = phong_kernel_checks(tag, path["pt"], cam, dev, path.pop("shadow_rays"))
    lap("kernels")
    golden = phong_golden_phase(tag, scene, cam, path["pt"], dev)
    lap("golden")
    fit = phong_fit_check(scene, cam, dev)
    lap("fit")
    # The same scene built and rendered flat (alpha 0: K1): the feature
    # changes the image.
    flat_scene, _ = scene_from_text(*cornell_sphere(), use_bvh=True)
    flat = PathTracer(flat_scene, bench_settings(size), device=dev,
                      lane_order=path["pt"].lane_order)
    flat.render(cam, frame_seed=0)
    moved = float((np.abs(path.pop("first") - flat.image()).max(axis=-1) > 1e-3).mean())
    phase(tag, f"first frame vs the flat scene's: {moved:.4%} of pixels differ by more than "
               f"1e-3")
    if moved < 0.005:
        raise AssertionError(f"{tag}: alpha {PHONG_ALPHA} barely changed the image ({moved})")
    del path["pt"], flat
    lap("flat frame")
    dtag = "phong dense"
    t1 = time.perf_counter()
    dense, _ = scene_from_text(*cornell_sphere(**PHONG_DENSE), use_bvh=True,
                               phong_tess_alpha=PHONG_ALPHA)
    phase(dtag, f"built in {time.perf_counter() - t1:.3f} s: {dense.tris.count} faces, "
                f"{dense.clusters.bb_min.x.shape[0]} clusters of {dense.clusters.size} (real "
                f"and padding), BVH {dense.bvh.count} nodes")
    dpath = phong_path(dtag, dense, cam, dev)
    lap("dense 1024² frames")
    dpasses = phong_kernel_checks(dtag, dpath.pop("pt"), cam, dev, dpath.pop("shadow_rays"))
    lap("dense kernels")
    dpath.pop("first")
    sec["phase"] = sum(sec.values())
    phase(tag, "seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in sec.items()))
    return {"path": path, "passes": passes, "golden": golden, "fit": fit,
            "cluster_min_rays": phongtess.CLUSTER_MIN_RAYS, "pixels_moved_by_alpha": moved,
            "dense": {"path": dpath, "passes": dpasses}, "seconds": sec}


# --------------------------------------------------------------- sharded --

SHARD_DIR = Path(__file__).resolve().parent / "build" / "pbr_tpu_torch" / "shard"
SHARD_SEED, SHARD_TIMEOUT = 3, 600.0


def shard_rank(rank: int, size: int, seed: int, target, dev) -> dict:
    """A spawned rank of the sharded phase, on ``dev`` with gloo: the
    Cornell box at ``size``² as a dp=2 and an sp=2 frame, then one dp=2
    training step; the results go back to the parent."""
    scene, cam = cornell()
    ts, cam_t = to_torch(scene, dev), camera_to_torch(cam, dev)
    settings = bench_settings(size)
    out = {}
    for n_dp, n_sp in ((2, 1), (1, 2)):
        mesh = make_mesh(n_dp, n_sp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        color, _ = sharded_render(mesh, ts, cam_t, settings, seed)
        torch.cuda.synchronize()
        out[f"{n_dp}x{n_sp}"] = (shard_index_map(mesh, size * size)[rank],
                                 color.stack().cpu().numpy(), (time.perf_counter() - t0) * 1e3)
    mesh = make_mesh(2, 1)
    t0 = time.perf_counter()
    loss, grads, _ = sharded_train_step(mesh, ts, cam_t, settings, target, seed)
    torch.cuda.synchronize()
    out["train"] = (float(loss), {k: g.cpu().numpy() for k, g in grads.items()},
                    (time.perf_counter() - t0) * 1e3)
    return out


def nccl_rank(rank: int, size: int, seed: int, dev):
    """A one-rank NCCL group: the Cornell frame through sharded_render."""
    scene, cam = cornell()
    color, _ = sharded_render(make_mesh(1, 1), to_torch(scene, dev), camera_to_torch(cam, dev),
                              bench_settings(size), seed)
    return torch.distributed.get_backend(), color.stack().cpu().numpy()


def _spawn(fn, world: int, args, dev, backend) -> tuple:
    """``spawn_ranks`` on ``dev`` with a fresh rendezvous file; the kernels
    are built already, so the ranks only load them."""
    SHARD_DIR.mkdir(parents=True, exist_ok=True)
    rdv = SHARD_DIR / "rendezvous"
    rdv.unlink(missing_ok=True)
    t0 = time.perf_counter()
    res = spawn_ranks(fn, world, f"file://{rdv}", args=(*args, str(dev)), device=str(dev),
                      backend=backend, timeout=SHARD_TIMEOUT)
    return res, time.perf_counter() - t0


def sharded_phase(dev, size: int = SIZE) -> dict:
    """Path "sharded" (pbr_tpu_torch/parallel): 2 spawned ranks on the one
    card over gloo (NCCL refuses two ranks on one device) against one
    process: dp=2 bitwise the unsharded frame, sp=2 within 1e-6 of the mean
    of the two shard seeds' frames, one dp=2 step's loss and gradients
    within 1e-4 of their largest magnitude; then a one-rank NCCL group
    through sharded_render, bitwise the unsharded frame. The times show
    that the code runs on the card; two ranks sharing one card say nothing
    of scaling, and NCCL across cards is not measured."""
    tag = "sharded"
    scene, cam = cornell()
    ts, cam_t = to_torch(scene, dev), camera_to_torch(cam, dev)
    settings = bench_settings(size)
    npx = size * size
    ids = torch.arange(npx, dtype=torch.int32, device=dev)
    frames = [trace_rays(ts, cam_t, settings, ids, _shard_seed(SHARD_SEED, k)).color.stack()
              .cpu().numpy() for k in range(2)]
    target = np.full((npx, 3), 0.5, dtype=np.float32)
    res, sec = _spawn(shard_rank, 2, (size, SHARD_SEED, target), dev, "gloo")
    dp = np.full((npx, 3), np.nan, dtype=np.float32)
    for r in res:
        sl, color, _ = r["2x1"]
        dp[sl] = color
    n_dp = int((dp != frames[0]).any(axis=1).sum())
    mean = (frames[0] + frames[1]) / 2.0
    sp_err = max(float(np.abs(r["1x2"][1] - mean).max()) for r in res)
    # One process's step: the loss of the frame of shard seed 0.
    ts.requires_grad_()
    leaf = leaf_camera(cam_t)
    params = render_params(ts, leaf)
    color = trace_rays(ts, leaf, settings, ids, _shard_seed(SHARD_SEED, 0)).color.stack()
    loss = ((color - torch.tensor(target, device=dev)) ** 2).sum() / float(3 * npx)
    loss_1 = float(loss.detach())
    ref = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    ref = {k: (torch.zeros_like(p) if g is None else g).cpu().numpy()
           for (k, p), g in zip(params.items(), ref)}
    ts.requires_grad_(False)
    worst = 0.0
    for r in res:
        got_loss, got, _ = r["train"]
        worst = max(worst, abs(got_loss - loss_1) / abs(loss_1))
        for k, g in ref.items():
            scale = float(np.abs(g).max()) if g.size else 0.0
            if scale:
                worst = max(worst, float(np.abs(got[k] - g).max()) / scale)
    times = {k: [round(r[k][-1], 1) for r in res] for k in ("2x1", "1x2", "train")}
    phase(tag, f"2 gloo ranks on one card, {size}² Cornell ({sec:.1f} s with start-up): dp=2 "
               f"vs the unsharded frame {n_dp} pixels differ; sp=2 vs the mean of the two "
               f"seeds' frames max |diff| {sp_err:.3g}; dp=2 step vs one process: loss "
               f"{res[0]['train'][0]:.6f} vs {loss_1:.6f}, worst relative error "
               f"{worst:.3g}; ms per rank {times} (not a scaling figure: two ranks share one "
               f"card)")
    if n_dp or sp_err > 1e-6 or worst > 1e-4:
        raise AssertionError(f"{tag}: dp {n_dp} pixels, sp {sp_err}, step {worst}")
    ((backend, color),), sec1 = _spawn(nccl_rank, 1, (size, SHARD_SEED), dev, None)
    n_nccl = int((color != frames[0]).any(axis=1).sum())
    phase(tag, f"one-rank {backend} group ({sec1:.1f} s with start-up): sharded_render vs the "
               f"unsharded frame: {n_nccl} pixels differ")
    if backend != "nccl" or n_nccl:
        raise AssertionError(f"{tag}: the {backend} frame differs on {n_nccl} pixels")
    return {"dp2_pixels_differ": n_dp, "sp2_max_abs_err": sp_err, "step_max_rel_err": worst,
            "rank_ms": times, "spawn_s": sec, "nccl_pixels_differ": n_nccl}


# ------------------------------------------------------ shading, K11/K12 --

SHADE_SOURCE = "pbr_tpu_torch/csrc/shade.cu"
SHADE_BWD_SOURCE = "pbr_tpu_torch/csrc/shade_bwd.cu"
SHADE_FWD = ("K11", "K12", "K12 pre", "K12 post")
SHADE_BWD = ("K11 bwd", "K12 bwd")
SHADE_KERNELS = SHADE_FWD + SHADE_BWD
COMPACT_SOURCE = "pbr_tpu_torch/csrc/compact.cu"
COMPACT_KERNELS = ("K13", "K13 bwd", "K14", "K14 bwd")
# The kernels of every frame, whatever its search: the shading, and
# compaction where the frame has a schedule.
FRAME_KERNELS = SHADE_KERNELS + COMPACT_KERNELS
# Operations for the bounds, counted by hand from csrc/shade.cu on a lane's
# common path (lower estimates; both kernels are bound by bytes many times
# over): K11 a lane (the pinhole, the jitter's frame and two normalisations,
# the RNG's hashes), K12 a live lane (normal, the hit point and shadow ray,
# the BRDF sample and two evaluations, throughput and the NEE sum), and
# "K12 pre" a lane (the hit point and shadow ray).
OPS_K11, OPS_K12_LIVE, OPS_K12_PRE = 120, 250, 30
# The backward's, counted the same way: K11 bwd a lane (the forward again,
# the jitter's and three normalisations' adjoints: 400), K12 bwd a live
# lane (the forward again and the two BRDF evaluations' adjoints: 900).
OPS_K11_BWD, OPS_K12_BWD_LIVE = 400, 900


def _clone(x):
    """``x`` with every tensor in it cloned (tuples and NamedTuples kept)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, PixelRng):
        r = object.__new__(PixelRng)
        r._base = x._base.clone()
        return r
    if isinstance(x, tuple):
        vals = [_clone(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def _recorded_shading(run) -> tuple:
    """(K11 calls, K12 calls) that ``run()`` made through the integrator's
    two wrappers, each with copies of its inputs and outputs, the instances
    it launched and, for "K12 pre", each shadow leg's ray and occluded bit."""
    import pbr_tpu_torch.models.integrator as integ

    gens, shades = [], []
    real_gen, real_shade = integ.gen_rays, integ.shade

    def gen(cam, settings, px, py, rng, s, prev_t):
        args = _clone((cam, settings, px, py, rng, s, prev_t))
        out = real_gen(cam, settings, px, py, rng, s, prev_t)
        gens.append({"args": args, "out": _clone(out)})
        return out

    def shd(cfg, lanes, hit, rng, s, depth, scene, occlude):
        rec = {"args": _clone((cfg, lanes, hit, rng, s, depth)), "scene": scene, "legs": []}

        def leg(hit_p, l_dir, t_light, casts):
            occ = occlude(hit_p, l_dir, t_light, casts)
            rec["legs"].append(_clone((hit_p, l_dir, t_light, casts, occ)))
            return occ

        before = dict(csh.launches)
        out = real_shade(cfg, lanes, hit, rng, s, depth, scene, leg)
        rec["inst"] = tuple(k for k in SHADE_FWD if csh.launches[k] > before[k])
        rec["out"] = _clone(out)
        shades.append(rec)
        return out

    integ.gen_rays, integ.shade = gen, shd
    try:
        run()
        torch.cuda.synchronize()
    finally:
        integ.gen_rays, integ.shade = real_gen, real_shade
    return gens, shades


def _leaves(x) -> list:
    """The tensors of ``x`` in order (Vec3s and tuples flattened, None kept)."""
    if isinstance(x, tuple):
        return [t for v in x for t in _leaves(v)]
    return [x]


def _bit_diff(what: str, got, ref) -> dict:
    """Lanes that differ between the tensors of ``got`` and ``ref``, as bit
    patterns (a NaN counts, -0 is not +0), by leaf: {leaf: (lanes, max
    ULP)} over the leaves that differ."""
    out = {}
    for i, (a, b) in enumerate(zip(_leaves(got), _leaves(ref))):
        if a is None and b is None:
            continue
        if a is None or b is None or a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what}: output {i} is {a} against {b}")
        if a.dtype == torch.float32:
            ai, bi = a.view(torch.int32), b.view(torch.int32)
            bad = ai != bi
            if bad.any():
                out[i] = (int(bad.sum()), int((ai.long() - bi.long()).abs().max()))
        elif not torch.equal(a, b):
            out[i] = (int((a != b).sum()), 0)
    return out


def _max_abs(got, ref) -> float:
    """The largest absolute difference between the tensors of ``got`` and
    ``ref`` over the lanes whose bit patterns differ (inf where a NaN or an
    infinity stands against another value; 0 when bitwise equal)."""
    worst = 0.0
    for a, b in zip(_leaves(got), _leaves(ref)):
        if a is None or b is None:
            continue
        if a.dtype == torch.float32:
            bad = a.view(torch.int32) != b.view(torch.int32)
            diff = torch.nan_to_num((a.double() - b.double()).abs(), nan=float("inf"))
        else:
            bad = a != b
            diff = (a.long() - b.long()).abs().double()
        if bad.any():
            worst = max(worst, float(diff[bad].max()))
    return worst


class _Stop(Exception):
    """Ends a plain shade at its shadow ray (the plain side of "K12 pre")."""


def shade_calls_check(tag: str, gens: list, shades: list) -> dict:
    """Every recorded K11 and K12 call held bitwise to its plain version on
    the same inputs: ``gen_rays_plain``; ``shade_plain`` with, for a pre and
    post pair, the kernel's shadow ray held to the plain one and the walk's
    recorded bit handed back. Raises naming each output that differs, its
    lanes and its largest ULP. Returns ({instance: calls checked},
    {instance: the largest absolute difference over those calls})."""
    checked = dict.fromkeys(SHADE_FWD, 0)
    errs = dict.fromkeys(SHADE_FWD, 0.0)
    for j, rec in enumerate(gens):
        ref = csh.gen_rays_plain(*rec["args"])
        bad = _bit_diff(f"{tag} K11 call {j}", rec["out"], ref)
        if bad:
            raise AssertionError(f"{tag}: K11 call {j} differs from its plain version "
                                 f"(output: (lanes, max ULP)) {bad}")
        checked["K11"] += 1
        errs["K11"] = max(errs["K11"], _max_abs(rec["out"], ref))
    for j, rec in enumerate(shades):
        legs = iter(rec["legs"])

        def plain_leg(hit_p, l_dir, t_light, casts):
            *ray, occ = next(legs)
            bad = _bit_diff(f"{tag} K12 pre {j}", tuple(ray), (hit_p, l_dir, t_light, casts))
            if bad:
                raise AssertionError(f"{tag}: K12 pre call {j} (bounce {rec['args'][5]}) "
                                     f"differs from its plain version: {bad}")
            errs["K12 pre"] = max(errs["K12 pre"], _max_abs(
                tuple(ray), (hit_p, l_dir, t_light, casts)))
            return occ

        ref = csh.shade_plain(*rec["args"], rec["scene"], plain_leg)
        bad = _bit_diff(f"{tag} K12 {j}", rec["out"], ref)
        if bad:
            raise AssertionError(f"{tag}: {rec['inst']} call {j} (bounce {rec['args'][5]}, "
                                 f"{rec['args'][2].t.shape[0]} lanes) differs from its plain "
                                 f"version (output: (lanes, max ULP)) {bad}")
        err = _max_abs(rec["out"], ref)
        for inst in rec["inst"]:
            checked[inst] += 1
            if inst != "K12 pre":  # pre's outputs are the shadow ray, held above
                errs[inst] = max(errs[inst], err)
    return checked, errs


def _shade_pattern(tag: str, launched: dict, frames: int, settings: RenderSettings,
                   backward: bool = False, camera: bool = True) -> str:
    """The shading launches of ``frames`` frames, forward (K11 once a
    sample; K12 once a bounce, fused, or "K12 pre" and "K12 post" once
    each) and, with ``backward`` (frames that autograd records), K12 bwd
    once a bounce and, where the camera requires grad (``camera``), K11
    bwd once a sample; flat-shaded and Phong frames alike. Raises
    otherwise; returns 'fused' or 'pre/post'."""
    samples = frames * settings.samples
    bounces = samples * settings.max_total_depth
    got = {k: launched.get(k, 0) for k in SHADE_KERNELS}
    bwd = {"K11 bwd": samples if backward and camera else 0,
           "K12 bwd": bounces if backward else 0}
    fused = {"K11": samples, "K12": bounces, "K12 pre": 0, "K12 post": 0, **bwd}
    split = {"K11": samples, "K12": 0, "K12 pre": bounces, "K12 post": bounces, **bwd}
    if got not in (fused, split):
        raise AssertionError(f"{tag}: shading launches {got} over {frames} "
                             f"{'forward+backward' if backward else 'forward'} frames, "
                             f"expected {fused} or {split}")
    return "fused" if got == fused else "pre/post"


@contextlib.contextmanager
def _plain_shading():
    """Within it the integrator's camera rays and shade are their plain
    versions (``gen_rays_plain``, ``shade_plain``: torch ops on any
    device), as ``_recorded_shading`` swaps them for its recorders."""
    import pbr_tpu_torch.models.integrator as integ

    real = integ.gen_rays, integ.shade
    integ.gen_rays, integ.shade = csh.gen_rays_plain, csh.shade_plain
    try:
        yield
    finally:
        integ.gen_rays, integ.shade = real


def _no_shading(tag: str, launched: dict) -> None:
    """A frame through the plain versions (``_plain_shading``) launches
    none of the shading kernels."""
    got = {k: launched.get(k, 0) for k in SHADE_KERNELS if launched.get(k)}
    if got:
        raise AssertionError(f"{tag}: a frame through the plain versions launched {got}")


def _shade_bytes(name: str, rec: dict) -> int:
    """Bytes that instance ``name`` must move on the recorded call: each
    lane input it reads and each output it writes once, and the tables it
    gathers (face, material, light) once. "K12 pre" reads what the break,
    the extension and the shadow ray need: no normal, and the RNG key only
    where the extension draws (Schlick)."""
    cfg, lanes, hit, rng = rec["args"][:4]
    scene, m = rec["scene"], rec["scene"].materials
    nb = lambda ts: sum(t.numel() * t.element_size() for t in ts if t is not None)  # noqa: E731
    n = hit.t.shape[0]
    if name == "K12 pre":  # o, d, alive, t, face, the key, the budget; the ray and casts
        schlick = cfg.brdf == BRDF_SCHLICK
        fields = (m.d, m.rough) if schlick else (m.d, m.nu, m.nv)
        tables = nb([scene.tris.mtl, *fields, *scene.lights.pos])
        return tables + n * (24 + 1 + 4 + 4 + (8 if schlick else 0) + 4) + n * (28 + 1)
    tables = nb([scene.tris.mtl, *scene.tris.e1, *scene.tris.e2, *_leaves(m),
                 *_leaves(scene.lights)])
    if cfg.pt_alpha > 0.0:
        tables += nb([*scene.tris.v0, *scene.tris.n0, *scene.tris.n1, *scene.tris.n2,
                      scene.flat])
    lane_in = nb([*_leaves(lanes), hit.t, hit.face, hit.u, hit.v, rng._base])
    occ = n if cfg.nee else 0
    return tables + lane_in + occ + n * (60 + 2 + 8) + occ  # the state and casts out


def _live_lanes(rec: dict) -> int:
    _, lanes, hit = rec["args"][:3]
    return int((lanes.alive & torch.isfinite(hit.t)).sum())


def _shade_timing(name: str, rec: dict) -> dict:
    """Instance ``name`` alone on a recorded call (20 launches captured in
    a CUDA graph: the wrapper's host time exceeds the kernel's), its plain
    version on the same inputs, and the bound."""
    if name == "K11":
        args = rec["args"]
        ms = k1_sweep.graph_ms(lambda: gen_rays(*args), 20)
        plain = _time_ms(lambda: csh.gen_rays_plain(*args), 5)
        cam, settings, n = args[0], args[1], args[2].shape[0]
        dof = float(cam.focus) >= 0.0  # prev_t and the lens draws only with depth of field
        key = 8 if dof or settings.anti_aliasing != 0.0 else 0
        bound = _bound(OPS_K11 * n, n * (4 + 4 + key + (4 if dof else 0) + 24))
        return {"ms": ms, "plain_ms": plain, "bound": bound, "lanes": n}
    cfg, lanes, hit, rng, s, depth = rec["args"]
    scene = rec["scene"]
    legs = rec["legs"]
    occ = legs[0][-1] if legs else hit.occluded
    h = hit if name == "K12 pre" else hit._replace(occluded=occ)
    ms = k1_sweep.graph_ms(
        lambda: csh.shade_launch(name, cfg, lanes, h, rng, s, depth, scene), 20)

    def stop(*_):
        raise _Stop

    def plain():
        try:  # "K12 pre": the plain shade up to its shadow ray
            csh.shade_plain(cfg, lanes, hit, rng, s, depth, scene,
                            stop if name == "K12 pre" else (lambda *_: occ))
        except _Stop:
            pass

    live = _live_lanes(rec)
    ops = OPS_K12_PRE * hit.t.shape[0] if name == "K12 pre" else OPS_K12_LIVE * live
    return {"ms": ms, "plain_ms": _time_ms(plain, 5),
            "bound": _bound(ops, _shade_bytes(name, rec)), "lanes": hit.t.shape[0],
            "live": live}


def _frame_through_plain(tag: str, pt: PathTracer, cam, seed: int) -> None:
    """One frame through the kernels (no autograd) bitwise the same frame
    through the plain versions (``_plain_shading``, which launches no
    shading kernel) and the frame that autograd records (the scene's
    parameters and the camera requiring grad: bench.py's backward step's),
    its colour detached; the recorded frame and its backward launch K11,
    K12, K11 bwd and K12 bwd (``_shade_pattern``)."""
    ct = camera_to_torch(cam, pt.device)
    run = lambda c: trace_rays(pt.scene, c, pt.settings, pt.pixel_ids, seed,  # noqa: E731
                               max_leaf=pt.max_leaf)
    zero_counts()
    with torch.no_grad():
        got = run(ct)
    torch.cuda.synchronize()
    launched = counts()
    pattern = _shade_pattern(f"{tag} frame", launched, 1, pt.settings)
    _compact_pattern(f"{tag} frame", launched, 1, pt.settings)
    zero_counts()
    with torch.no_grad(), _plain_shading():
        plain = run(ct)
    torch.cuda.synchronize()
    _no_shading(f"{tag} plain frame", counts())
    pt.scene.requires_grad_()
    try:
        zero_counts()
        with torch.enable_grad():
            res = run(leaf_camera(ct))
            (res.color.x.sum() + res.color.y.sum() + res.color.z.sum()).backward()
            rec = (res.color.detach(), res.focus_t.detach())
        torch.cuda.synchronize()
        launched = counts()
        grad_pattern = _shade_pattern(f"{tag} grad path", launched, 1, pt.settings,
                                      backward=True)
        _compact_pattern(f"{tag} grad path", launched, 1, pt.settings, backward=True)
    finally:
        pt.scene.requires_grad_(False)
        pt.scene.zero_grad(set_to_none=True)
    for what, ref in (("the plain versions'", (plain.color, plain.focus_t)),
                      ("the grad path's", rec)):
        bad = _bit_diff(f"{tag} frame", (got.color, got.focus_t), ref)
        if bad:
            raise AssertionError(f"{tag}: the frame through K11/K12 differs from {what} "
                                 f"(output: (lanes, max ULP)) {bad}")
    phase("shade", f"{tag}: a {SIZE}² frame through K11 and K12 ({pattern}) bitwise the same "
                   f"frame through the plain versions and the frame autograd records, whose "
                   f"backward ran {grad_pattern}: "
                   f"{ {k: launched.get(k, 0) for k in FRAME_KERNELS} }")


def _recorded_backward(run) -> tuple:
    """(K11 bwd calls, K12 bwd calls) of ``run()``'s backward, each with
    copies of its inputs and outputs."""
    gens, shades = [], []
    real_gen, real_shade = csh.gen_rays_bwd_launch, csh.shade_bwd_launch

    def gen(*args):
        out = real_gen(*args)
        gens.append({"args": _clone(args), "out": out.clone()})
        return out

    def shd(cfg, lanes, hit, rng, s, depth, scene, g):
        out = real_shade(cfg, lanes, hit, rng, s, depth, scene, g)
        shades.append({"args": _clone((cfg, lanes, hit, rng, s, depth)), "scene": scene,
                       "g": _clone(g), "out": _clone(out)})
        return out

    csh.gen_rays_bwd_launch, csh.shade_bwd_launch = gen, shd
    try:
        run()
        torch.cuda.synchronize()
    finally:
        csh.gen_rays_bwd_launch, csh.shade_bwd_launch = real_gen, real_shade
    return gens, shades


def _sums_err(what: str, got, ref, abs_sum) -> float:
    """Sums of the same terms in another order: each within 1e-5 of the
    float64 sum of its terms' absolute values of ``ref``, their float64
    sum; raises otherwise. Returns the largest absolute difference."""
    err = (got.double() - ref).abs()
    if not bool(torch.isfinite(got).all()) or bool((err > 1e-5 * abs_sum).any()):
        worst = float((err / abs_sum.clamp_min(1e-30)).max())
        raise AssertionError(f"{what}: a sum off by {worst:.3g} of its terms' absolute sum")
    return float(err.max()) if err.numel() else 0.0


def shade_bwd_check(tag: str, gens: list, shades: list) -> tuple:
    """Every recorded K12 bwd call against its plain adjoint on the same
    inputs (``shade_vjp_terms``): each lane's gradients bitwise (as bit
    patterns), the table's within 1e-5 of the float64 sum of its terms'
    absolute values of their float64 sum (the plain adjoint's float32 sum,
    ``table_sum``, carries its own rounding: its error is printed beside);
    every K11 bwd call's camera gradients the same way
    (``gen_rays_vjp_terms``). Raises naming what differs. Returns
    ({instance: calls checked}, {instance: the largest absolute
    difference})."""
    checked = dict.fromkeys(SHADE_BWD, 0)
    errs = dict.fromkeys(SHADE_BWD, 0.0)
    plain = 0.0  # the plain adjoint's float32 sums against the float64 ones
    for j, rec in enumerate(gens):
        terms = csh.gen_rays_vjp_terms(*rec["args"]).double()
        errs["K11 bwd"] = max(errs["K11 bwd"], _sums_err(
            f"{tag} K11 bwd call {j}", rec["out"], terms.sum(dim=1), terms.abs().sum(dim=1)))
        checked["K11 bwd"] += 1
    for j, rec in enumerate(shades):
        scene = rec["scene"]
        lane, g_t, terms = csh.shade_vjp_terms(*rec["args"], scene, rec["g"])
        bad = _bit_diff(f"{tag} K12 bwd {j}", rec["out"][:2], (lane, g_t))
        if bad:
            raise AssertionError(f"{tag}: K12 bwd call {j} (bounce {rec['args'][5]}, "
                                 f"{rec['args'][2].t.shape[0]} lanes) differs from its plain "
                                 f"adjoint (output: (lanes, max ULP)) {bad}")
        m, nl = int(scene.materials.d.shape[0]), scene.lights.count
        ref = csh.table_sum(terms, m, nl, torch.float64)
        t64 = terms._replace(mat=terms.mat.abs(), pos=terms.pos.abs(), rgb=terms.rgb.abs())
        err = _sums_err(f"{tag} K12 bwd call {j} table", rec["out"][2], ref,
                        csh.table_sum(t64, m, nl, torch.float64))
        plain = max(plain, float((csh.table_sum(terms, m, nl).double() - ref).abs().max()))
        errs["K12 bwd"] = max(errs["K12 bwd"], err, _max_abs(rec["out"][:2], (lane, g_t)))
        checked["K12 bwd"] += 1
        del lane, g_t, terms
    phase("shade", f"{tag}: the largest difference from the float64 sums: K12 bwd's table "
                   f"{errs['K12 bwd']:.3g}, K11 bwd's camera {errs['K11 bwd']:.3g}; the plain "
                   f"adjoint's float32 table {plain:.3g}")
    return checked, errs


def _bwd_timing(name: str, rec: dict) -> dict:
    """K11 bwd or K12 bwd alone on a recorded call (20 launches captured in
    a CUDA graph), its plain adjoint on the same inputs, and the bound:
    each input read once (the lanes' state the forward read, the outputs'
    gradients, the tables) and each output written once (the inputs'
    gradients but the final colour's, which is its upstream gradient
    itself: 13 a lane; the table); the operations of OPS_K11_BWD a lane
    and OPS_K12_BWD_LIVE a live lane."""
    nb = lambda ts: sum(t.numel() * t.element_size() for t in ts if t is not None)  # noqa: E731
    if name == "K11 bwd":
        args = rec["args"]
        ms = k1_sweep.graph_ms(lambda: csh.gen_rays_bwd_launch(*args), 20)
        plain = _time_ms(lambda: csh.gen_rays_vjp_plain(*args), 5)
        cam, settings, px, py, rng, s, prev_t, g_o, g_d = args
        n = px.shape[0]
        dof = float(cam.focus) >= 0.0
        lane_in = nb([px, py, rng._base, *g_o, *g_d]) + (nb([prev_t]) if dof else 0)
        bound = _bound(OPS_K11_BWD * n, lane_in + 15 * 4)
        return {"ms": ms, "plain_ms": plain, "bound": bound, "lanes": n}
    cfg, lanes, hit, rng, s, depth = rec["args"]
    scene, g = rec["scene"], rec["g"]
    args = (cfg, lanes, hit, rng, s, depth, scene, g)
    ms = k1_sweep.graph_ms(lambda: csh.shade_bwd_launch(*args), 20)
    plain = _time_ms(lambda: csh.shade_vjp_plain(*args), 5)
    n = hit.t.shape[0]
    phong = cfg.pt_alpha > 0.0
    tables = nb([scene.tris.mtl, *scene.tris.e1, *scene.tris.e2, *_leaves(scene.materials),
                 *_leaves(scene.lights)])
    if phong:
        tables += nb([*scene.tris.v0, *scene.tris.n0, *scene.tris.n1, *scene.tris.n2,
                      scene.flat])
    lane_in = nb([*lanes.o, *lanes.d, *lanes.color, lanes.alive, lanes.depth_added, hit.t,
                  hit.face, hit.u if phong else None, hit.v if phong else None,
                  hit.occluded if cfg.nee else None, rng._base, *_leaves(g)])
    rows = 14 * int(scene.materials.d.shape[0]) + 6 * scene.lights.count
    live = _live_lanes(rec)
    bound = _bound(OPS_K12_BWD_LIVE * live, tables + lane_in + n * 13 * 4 + rows * 4)
    return {"ms": ms, "plain_ms": plain, "bound": bound, "lanes": n, "live": live}


WIDE_MATERIALS = 600  # 14 x 600 + 6 table rows: a block's 8 warp rows need 269 KB


def wide_table_check(tag: str, rec: dict) -> dict:
    """K12 bwd on a recorded call over a table of WIDE_MATERIALS materials
    (the scene's, repeated with each copy's colours scaled, and the faces'
    materials drawn at random), whose warp rows do not fit in a block's
    shared memory: the lanes' gradients bitwise the plain adjoint's, the
    table's sums within 1e-5 of their terms' absolute sums, a second launch
    bitwise the first. Returns the largest difference of a sum."""
    cfg, lanes, hit, rng, s, depth = rec["args"]
    scene = rec["scene"]
    mats, m0 = scene.materials, int(scene.materials.d.shape[0])
    reps = -(-WIDE_MATERIALS // m0)
    dev = hit.t.device
    k = torch.arange(reps * m0, device=dev)[:WIDE_MATERIALS] // m0
    rep = lambda f: f.repeat(reps)[:WIDE_MATERIALS].contiguous()  # noqa: E731
    tint = lambda v: Vec3(*(rep(c) * (1.0 - 0.0005 * k) for c in v))  # noqa: E731
    wide = mats._replace(**{f: rep(getattr(mats, f)) for f in
                            ("d", "Ni", "rough", "p", "nu", "nv", "Rs", "Rd", "light")},
                         kd=tint(mats.kd), ks=tint(mats.ks))
    gen = torch.Generator(device=dev).manual_seed(9)
    mtl = torch.randint(0, WIDE_MATERIALS, scene.tris.mtl.shape, device=dev, generator=gen,
                        dtype=torch.int32)
    sc = scene._replace(tris=scene.tris._replace(mtl=mtl), materials=wide)
    args = (cfg, lanes, hit, rng, s, depth, sc, rec["g"])
    got = csh.shade_bwd_launch(*args)
    again = csh.shade_bwd_launch(*args)
    lane, g_t, terms = csh.shade_vjp_terms(*args)
    bad = _bit_diff(f"{tag} K12 bwd, {WIDE_MATERIALS} materials", got[:2], (lane, g_t))
    bad.update({f"again {k}": v for k, v in _bit_diff(f"{tag} K12 bwd again", again, got).items()})
    if bad:
        raise AssertionError(f"{tag}: K12 bwd over {WIDE_MATERIALS} materials differs from its "
                             f"plain adjoint or from itself (output: (lanes, max ULP)) {bad}")
    nl = sc.lights.count
    t64 = terms._replace(mat=terms.mat.abs(), pos=terms.pos.abs(), rgb=terms.rgb.abs())
    err = _sums_err(f"{tag} K12 bwd table, {WIDE_MATERIALS} materials", got[2],
                    csh.table_sum(terms, WIDE_MATERIALS, nl, torch.float64),
                    csh.table_sum(t64, WIDE_MATERIALS, nl, torch.float64))
    used = int(torch.unique(terms.midx[terms.mat.abs().sum(dim=0) > 0]).numel())
    phase("shade", f"{tag}: K12 bwd over {WIDE_MATERIALS} materials ({used} with terms; the "
                   f"warp rows in global memory) bitwise its plain adjoint on "
                   f"{hit.t.shape[0]} lanes, repeats bitwise, the table within {err:.3g}")
    return {"materials": WIDE_MATERIALS, "with_terms": used, "max_abs_err": err}


def _backward_step(pt: PathTracer, cam, seed: int):
    """bench.py's backward step on one frame of ``pt`` (every material,
    light and camera parameter requiring grad), eager."""
    ct = leaf_camera(camera_to_torch(cam, pt.device))
    pt.scene.requires_grad_()
    try:
        params = list(render_params(pt.scene, ct).values())
        res = trace_rays(pt.scene, ct, pt.settings, pt.pixel_ids, seed, max_leaf=pt.max_leaf)
        loss = res.color.x.sum() + res.color.y.sum() + res.color.z.sum()
        torch.autograd.grad(loss, params, allow_unused=True)
    finally:
        pt.scene.requires_grad_(False)


def shade_phase(dev, scene_s, cam_s) -> dict:
    """K11 and K12 and their backward on the card (``ops/cuda_shade.py``):
    on each case's eager 1024² frame, every K11 and K12 call recorded and
    held bitwise to its plain version (``shade_calls_check``): Cornell (K1,
    fused: SA and Schlick, NEE on and off, a glass material with
    transparency on; the compacted bounces), multiroom (K3, whose shadow
    leg comes with the search: fused), soup:100000 (K8 with its any-hit
    walk: pre and post, the orb light) and the Phong sphere (K9 any-hit:
    pre and post, curved normals); on each case's backward step
    (bench.py's: every material, light and camera parameter), every K11
    bwd and K12 bwd call recorded and held to its plain adjoint
    (``shade_bwd_check``: the lanes' gradients bitwise, the sums within
    1e-5 of their terms' absolute sums), and Cornell's bounce 0 over 600
    materials (``wide_table_check``); the frames of Cornell, multiroom,
    soup:100000 and the Phong sphere through the kernels bitwise the plain
    versions' and the grad path's (``_frame_through_plain``); each
    instance timed on its main path's bounce 0 against its plain version,
    with its bound; on Cornell's and the sphere's backward steps every
    compaction call, K13, K14 and their backward, bitwise its plain
    version (``compact_phase``), each instance timed on Cornell's first
    stage."""
    t_phase = time.perf_counter()
    scene_c, cam_c = cornell()
    scene_m, cam_m = multiroom()
    scene_p, _ = scene_from_text(*cornell_sphere(), use_bvh=True, phong_tess_alpha=PHONG_ALPHA)
    obj, mtl, li = cornell_box()
    glass, _ = scene_from_text(obj, mtl, li, use_bvh=False)
    d = np.asarray(glass.materials.d).copy()
    d[-2] = 0.3  # the glossy block turns transparent
    glass = glass._replace(materials=glass.materials._replace(d=d, Ni=np.full_like(d, 1.5)))
    cases = (
        ("cornell", scene_c, cam_c, {}, True),
        ("cornell, Schlick", scene_c, cam_c, {"brdf": 0}, False),
        ("cornell, NEE off", scene_c, cam_c, {"shadow_rays": 0}, False),
        ("cornell, glass", glass, cam_c, {"no_transparency": False}, False),
        ("multiroom", scene_m, cam_m, {}, True),
        ("soup:100000", scene_s, cam_s, {}, True),
        ("phong", scene_p, cam_c, {"phong_tessellation": PHONG_ALPHA}, True),
    )
    out = {"checked": {}, "checked_bwd": {}, "checked_compact": {}, "times": {},
           "errs": dict.fromkeys(FRAME_KERNELS, 0.0)}
    timing = {"K11": ("cornell", "gen"), "K12": ("cornell", "shade"),
              "K12 pre": ("soup:100000", "shade"), "K12 post": ("soup:100000", "shade")}
    for tag, scene, cam, kw, vs_plain in cases:
        pt = PathTracer(scene, bench_settings(SIZE, compact_schedule="auto", **kw), device=dev)
        pt.render(cam, frame_seed=0)  # the probes and the capture
        if "no_transparency" in kw and pt.settings.no_transparency:
            raise AssertionError(f"{tag}: the frame skips the transmit branch")
        gens, shades = _recorded_shading(lambda: eager_frame(pt, cam, 3))
        checked, errs = shade_calls_check(tag, gens, shades)
        for k, v in errs.items():
            out["errs"][k] = max(out["errs"][k], v)
        lanes = [r["args"][2].t.shape[0] for r in shades]
        phase("shade", f"{tag}: {checked} calls bitwise their plain versions, the bounces' "
                       f"lanes {lanes} (schedule {pt.settings.compact_schedule})")
        out["checked"][tag] = checked
        for name, (where, kind) in timing.items():
            if where == tag and name not in out["times"]:
                rec = gens[0] if kind == "gen" else next(
                    r for r in shades if (name in r["inst"] or name == "K12")
                    and (name != "K12" or r["inst"] == ("K12",)))
                out["times"][name] = _shade_timing(name, rec)
        del gens, shades
        comp = []  # Cornell's and the sphere's compaction calls (K13, K14, their backward)
        with _recorded_compaction(comp) if tag in ("cornell", "phong") else \
                contextlib.nullcontext():
            gens, shades = _recorded_backward(lambda: _backward_step(pt, cam, 5))
        if comp:
            checked, errs, times = compact_phase(tag, pt, comp, timed=tag == "cornell")
            out["checked_compact"][tag] = checked
            out["times"].update(times)
            for k, v in errs.items():
                out["errs"][k] = max(out["errs"][k], v)
        del comp
        checked, errs = shade_bwd_check(tag, gens, shades)
        want = {"K11 bwd": pt.settings.samples,
                "K12 bwd": pt.settings.samples * pt.settings.max_total_depth}
        if checked != want:
            raise AssertionError(f"{tag}: the backward step ran {checked}, expected {want}")
        for k, v in errs.items():
            out["errs"][k] = max(out["errs"][k], v)
        phase("shade", f"{tag}: the backward step's {checked} calls held to their plain "
                       f"adjoints (the lanes' gradients bitwise; the largest difference "
                       f"of a sum {errs})")
        out["checked_bwd"][tag] = checked
        if tag == "cornell":
            bounce0 = next(r for r in shades if r["args"][5] == 0)
            out["times"]["K11 bwd"] = _bwd_timing("K11 bwd", gens[0])
            out["times"]["K12 bwd"] = _bwd_timing("K12 bwd", bounce0)
            out["wide_table"] = wide_table_check(tag, bounce0)
        elif tag == "phong":
            out["times"]["K12 bwd (Phong)"] = _bwd_timing(
                "K12 bwd", next(r for r in shades if r["args"][5] == 0))
        del gens, shades
        if vs_plain:
            _frame_through_plain(tag, pt, cam, 4)
        del pt
        torch.cuda.empty_cache()
    for name, row in out["times"].items():
        lib, where = "", f"{row['lanes']} lanes"
        how = "20 launches from a CUDA graph"
        if "library_ms" in row:
            lib = (f", one PyTorch call a field {row['library_ms']:.4f} ms (warm "
                   f"{row['library_ms_warm']:.4f})")
            where = (f"a stage of {row['cap']} of {row['rows']} rows ({row['n_ok']} live), "
                     f"{row['fields']} fields")
            how += f", each after an L2 flush; warm {row['ms_warm']:.4f} ms"
        phase("shade", f"{name} on {where}: {row['ms']:.4f} ms ({how}), plain "
                       f"{row['plain_ms']:.4f} ms{lib}, bound "
                       f"{row['bound'][0]:.4f} ms ({row['bound'][1]})")
    out["seconds"] = time.perf_counter() - t_phase
    phase("shade", f"phase took {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------ compaction, K13/K14 --


def _stages(settings: RenderSettings, batch: int) -> int:
    """The schedule stages of a sample of ``batch`` lanes under
    ``settings``, by the integrator's own rule."""
    import pbr_tpu_torch.models.integrator as integ

    return len(integ.stage_plan(settings, batch)[1])


def _compact_pattern(tag: str, launched: dict, frames: int, settings=None,
                     backward: bool = False, batch: int = SIZE * SIZE) -> int:
    """Compaction's launches over ``frames`` frames of ``batch`` lanes: K13
    and K14 once a stage of each sample of ``settings``' schedule, and with
    ``backward`` (frames that autograd records) K13 bwd and K14 bwd as
    often; without ``settings`` (a schedule probed out of sight), the four
    counts alike and whole frames of them. Raises otherwise; returns the
    stages a frame."""
    got = {k: launched.get(k, 0) for k in COMPACT_KERNELS}
    n = got["K13"] if settings is None else frames * settings.samples * _stages(settings, batch)
    want = {"K13": n, "K14": n, "K13 bwd": n if backward else 0,
            "K14 bwd": n if backward else 0}
    if got != want or n % frames:
        raise AssertionError(f"{tag}: compaction launches {got} over {frames} "
                             f"{'forward+backward' if backward else 'forward'} frames, "
                             f"expected {want}")
    return n // frames


@contextlib.contextmanager
def _recorded_compaction(calls: list):
    """Within it every launch of K13, K13 bwd, K14 and K14 bwd
    (``cuda_compact.compact_launch``, which the wrappers and the autograd
    Functions call) is recorded into ``calls``: the instance, copies of
    its plan and inputs, and copies of its outputs."""
    real = ccp.compact_launch

    def rec(name, plan, ins, prevs=None, live=False):
        out = real(name, plan, ins, prevs=prevs, live=live)
        calls.append({"name": name, "plan": _clone(plan), "ins": _clone(tuple(ins)),
                      "prevs": None if prevs is None else _clone(tuple(prevs)), "live": live,
                      "out": _clone(tuple(out))})
        return out

    ccp.compact_launch = rec
    try:
        yield
    finally:
        ccp.compact_launch = real


def _compact_plain(rec: dict) -> tuple:
    """A recorded call's outputs by its instance's plain version."""
    return tuple(ccp.plain_launch(rec["name"], rec["plan"], list(rec["ins"]),
                                  prevs=None if rec["prevs"] is None else list(rec["prevs"])))


def compact_calls_check(tag: str, calls: list) -> tuple:
    """Every recorded compaction call held bitwise to its plain version on
    the same inputs (as bit patterns: -0.0 is not +0.0). Raises naming each
    output that differs, its lanes and its largest ULP. Returns
    ({instance: calls checked}, {instance: the largest absolute
    difference})."""
    checked = dict.fromkeys(COMPACT_KERNELS, 0)
    errs = dict.fromkeys(COMPACT_KERNELS, 0.0)
    for j, rec in enumerate(calls):
        name, plan = rec["name"], rec["plan"]
        ref = _compact_plain(rec)
        bad = _bit_diff(f"{tag} {name} call {j}", rec["out"], ref)
        if bad:
            raise AssertionError(f"{tag}: {name} call {j} (cap {plan.cap} of "
                                 f"{plan.slot.shape[0]} rows, {len(rec['ins'])} fields) differs "
                                 f"from its plain version (output: (lanes, max ULP)) {bad}")
        checked[name] += 1
        errs[name] = max(errs[name], _max_abs(rec["out"], ref))
    return checked, errs


def _compact_library(rec: dict) -> list:
    """One PyTorch call a field that computes the recorded call's function
    (the yardstick, used nowhere in the port): ``index_select`` through
    ``src`` on the (R, block) view for K13 and K14 bwd; ``index_put`` with
    accumulate through ``src`` (the old gathers' backward, which sorts the
    indices) for K13 bwd (into zeros) and K14 (into the outer stage's
    field)."""
    name, plan, ins = rec["name"], rec["plan"], rec["ins"]
    b, rows = plan.block, plan.slot.shape[0]
    src = plan.src.long()
    if name in ("K13", "K14 bwd"):
        return [lambda v=v: v.view(-1, b).index_select(0, src) for v in ins]
    if name == "K13 bwd":
        return [lambda g=g: torch.zeros((rows, b), dtype=g.dtype, device=g.device).index_put_(
            (src,), g.view(-1, b), accumulate=True) for g in ins]
    return [lambda p=p, c=c: p.view(-1, b).index_put((src,), c.view(-1, b), accumulate=True)
            for p, c in zip(rec["prevs"], ins)]


def _compact_bytes(rec: dict) -> int:
    """Bytes the recorded call's function must move: the rows each field's
    output reads (the n_ok live slots' rows of a gathered field; K14 also
    the outer stage's field whole), its output written once, the index
    map and n_ok."""
    name, plan, ins = rec["name"], rec["plan"], rec["ins"]
    n_ok, b, rows = int(plan.n_ok), plan.block, plan.slot.shape[0]
    out_rows = plan.cap if name in ("K13", "K14 bwd") else rows
    idx = 4 * (plan.cap if name in ("K13", "K14 bwd") else rows) + 4
    per = sum(x.element_size() * b * (n_ok + out_rows + (rows if name == "K14" else 0))
              for x in ins)
    return per + idx


L2_FLUSH_FLOATS = 16 << 20  # 64 MB read between timed calls: more than the H100's 50 MB L2


def _cold_ms(fn, flush) -> tuple:
    """``(cold, warm)`` ms a call of ``fn``: 20 calls captured in a CUDA
    graph, each after a read of ``flush`` (more than the L2 cache holds, so
    the call finds its inputs in device memory, as the frame's call does),
    less 20 such reads alone; and 20 calls in a row, the inputs in L2
    after the first (a stage's tensors fit in it)."""
    read = lambda: flush.sum()  # noqa: E731
    both = k1_sweep.graph_ms(lambda: (read(), fn()), 20)
    return both - k1_sweep.graph_ms(read, 20), k1_sweep.graph_ms(fn, 20)


def _compact_timing(rec: dict) -> dict:
    """A recorded call's instance alone and the library calls
    (``_compact_library``, a field each), both cold and warm
    (``_cold_ms``), its plain version, and the bound (bytes; K14's adds
    are its only operations)."""
    name, plan, ins, prevs = rec["name"], rec["plan"], list(rec["ins"]), rec["prevs"]
    flush = torch.ones(L2_FLUSH_FLOATS, device=ins[0].device)
    ms, warm = _cold_ms(lambda: ccp.compact_launch(
        name, plan, ins, prevs=None if prevs is None else list(prevs), live=rec["live"]), flush)
    library = _compact_library(rec)
    lib_ms, lib_warm = _cold_ms(lambda: [f() for f in library], flush)
    ops = len(ins) * plan.slot.shape[0] * plan.block if name == "K14" else 0
    return {"ms": ms, "ms_warm": warm, "plain_ms": _time_ms(lambda: _compact_plain(rec), 5),
            "library_ms": lib_ms, "library_ms_warm": lib_warm,
            "bound": _bound(ops, _compact_bytes(rec)),
            "lanes": ins[0].shape[0], "fields": len(ins), "n_ok": int(plan.n_ok),
            "cap": plan.cap, "rows": plan.slot.shape[0]}


def compact_phase(tag: str, pt: PathTracer, calls: list, timed: bool) -> tuple:
    """The compaction calls recorded over one backward step of ``pt``:
    each instance once a stage of its schedule, every call bitwise its
    plain version (``compact_calls_check``); with ``timed``, each
    instance timed on the first stage's call (the widest). Returns
    ({instance: calls checked}, {instance: largest difference},
    {instance: timing})."""
    stages = _stages(pt.settings, pt.pixel_ids.shape[0])
    checked, errs = compact_calls_check(tag, calls)
    if stages < 1 or checked != dict.fromkeys(COMPACT_KERNELS, stages):
        raise AssertionError(f"{tag}: the backward step ran compaction {checked}, expected "
                             f"each of {COMPACT_KERNELS} once a stage of "
                             f"{pt.settings.compact_schedule}")
    times = {}
    if timed:
        for name in COMPACT_KERNELS:
            times[name] = _compact_timing(max((r for r in calls if r["name"] == name),
                                              key=lambda r: r["plan"].cap))
    phase("shade", f"{tag}: the backward step's compaction {checked} bitwise their plain "
                   f"versions (schedule {pt.settings.compact_schedule}; the stages' live rows "
                   f"{[int(r['plan'].n_ok) for r in calls if r['name'] == 'K13']} of "
                   f"{[r['plan'].cap for r in calls if r['name'] == 'K13']})")
    return checked, errs, times


# ----------------------------------------------------------- CUDA graphs --

# The graph phase's frames: (tag, scene, settings, the kernels its frame
# launches, each once a bounce). Every band of ``auto`` (ops/traverse.py::
# AUTO_BANDS: K1, K3, K8, and on a scene without clusters above 10,000
# faces the tree: K8 where the single-tree walk holds it, as on the band
# table's soup:10001), then every explicit mode.
GRAPH_PATHS = (
    ("cornell", "cornell", {}, ("K1",)),
    ("multiroom", "multiroom", {}, ("K3", "K3 any-hit")),
    ("soup:100000", "soup:100000", {}, ("K8", "K8 any-hit")),
    ("soup:10001, no clusters", "soup:10001 plain", {}, ("K8", "K8 any-hit")),
    ("multiroom, pallas", "multiroom", {"intersector": "pallas"}, ("K1",)),
    ("multiroom, cull", "multiroom", {"intersector": "cull"}, ("K4m", "K4m any-hit")),
    ("multiroom, sweep", "multiroom", {"intersector": "sweep"}, ("K5m", "K5m any-hit")),
    ("multiroom, gemm", "multiroom", {"intersector": "gemm"}, ()),
    ("soup:100000, cull", "soup:100000", {"intersector": "cull"}, ("K4", "K4 any-hit")),
    ("soup:100000, sweep", "soup:100000", {"intersector": "sweep"}, ("K5", "K5 any-hit")),
    ("soup:100000, pallas_bvh_hbm", "soup:100000", {"intersector": "pallas_bvh_hbm"},
     ("K7 NEE",)),
    ("soup:100000, pallas_bvh_forest", "soup:100000 forest",
     {"intersector": "pallas_bvh_forest"},
     ("K6 nearest", "K6 seeded", "K6 any-hit", "K6 seeded any-hit")),
    ("soup:10000, pallas_bvh", "soup:10000", {"intersector": "pallas_bvh"}, ("K6 NEE",)),
)
GRAPH_FRAMES = 4  # frames a check and a timing round
GRAPH_PROFILED = 2  # bare replays under the profiler


def _state_copy(state) -> tuple:
    return tuple(t.clone() for t in (*state.rgb, state.depth, state.sample_count))


def _timed_ms(fn, n: int) -> float:
    """CUDA-event ms a call over ``n`` calls of ``fn(i)`` in a row."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_frame_check(tag: str, scene, cam, dev, kernels: tuple, **kw) -> dict:
    """One path's captured frame step (``PathTracer``, ``kw``: settings):
    ``warmup`` captures it; GRAPH_FRAMES replayed frames, the camera moved
    after the second, each bitwise the frame of the eager ``render_frame``
    on the same scene, settings and lanes; the graph's kernel nodes of the
    port (read from the driver) equal an eager frame's launches,
    ``kernels`` each once a bounce and no other, and ``counts()`` over the
    replays GRAPH_FRAMES times those, and so the port's kernels that the
    device ran over GRAPH_PROFILED bare replays (torch.profiler,
    ``graph_steps.profiled_replays``); then eager and
    graphed ms/frame, two interleaved rounds of GRAPH_FRAMES frames
    each (one for an explicit mode, ``kw`` non-empty)."""
    pt = PathTracer(scene, bench_settings(SIZE, compact_schedule="auto", **kw), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pt.warmup(cam)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    g = pt.graph
    if g is None or g.graph is None or pt.sample_count != 0:
        raise AssertionError(f"graph {tag}: warmup did not capture the frame step")
    nodes = kernel_counts(g.kernels)  # the port's kernel nodes, as the driver holds them
    eye = cam.eye
    moved = cam._replace(eye=eye._replace(x=np.float32(eye.x + 0.05)))
    cams = [cam, cam, moved, moved]
    zero_counts()
    got = []
    for i, c in enumerate(cams):
        pt.render(c, frame_seed=i)
        got.append(_state_copy(pt.state))
    replayed = {k: v for k, v in counts().items() if v}
    mtd = pt.settings.max_total_depth
    state = init_frame_state(SIZE * SIZE, dev)
    eager_launches = None
    for i, c in enumerate(cams):
        zero_counts()
        with torch.no_grad():
            state = render_frame(pt.scene, camera_to_torch(c, dev), pt.settings, state,
                                 pt.pixel_ids, i, max_leaf=pt.max_leaf)
        if i == 0:
            eager_launches = {k: v for k, v in counts().items() if v}
        ref = _state_copy(state)
        bad = [j for j, (a, b) in enumerate(zip(got[i], ref)) if not torch.equal(a, b)]
        if bad:
            n_px = int((got[i][0] != ref[0]).sum())
            raise AssertionError(f"graph {tag}: frame {i} differs from the eager frame in "
                                 f"state fields {bad} ({n_px} pixels of rgb.x)")
    _expect(f"graph {tag}, eager", eager_launches, dict.fromkeys(kernels, mtd))
    shading = _shade_pattern(f"graph {tag}", nodes, 1, pt.settings)
    _compact_pattern(f"graph {tag}", nodes, 1, pt.settings)
    if nodes != eager_launches:
        raise AssertionError(f"graph {tag}: the graph holds {nodes} of the port's kernel "
                             f"nodes, an eager frame launches {eager_launches}")
    frames_of = {k: GRAPH_FRAMES * v for k, v in eager_launches.items()}
    _expect(f"graph {tag}, counts() over {GRAPH_FRAMES} replays", replayed, frames_of)
    # The port's kernels that the device ran over bare replays.
    _expect(f"graph {tag}, the device over {GRAPH_PROFILED} replays",
            graph_steps.profiled_replays(g, GRAPH_PROFILED),
            {k: GRAPH_PROFILED * v for k, v in eager_launches.items()})
    ct = camera_to_torch(cam, dev)

    def eager(i):
        with torch.no_grad():
            render_frame(pt.scene, ct, pt.settings, state, pt.pixel_ids, 10 + i,
                         max_leaf=pt.max_leaf)

    ms = {"eager": [], "graph": []}
    for r in range(1 if kw else 2):  # an explicit mode: one round
        ms["eager"].append(_timed_ms(eager, GRAPH_FRAMES))
        ms["graph"].append(_timed_ms(lambda i: pt.render(cam, frame_seed=20 + 10 * r + i),
                                     GRAPH_FRAMES))
    st = g.stats()
    phase("graph", f"{tag}: warmup {warm_s:.3f} s (probes, the eager frame, capture "
                   f"{st['capture_s']:.3f} s), {st['nodes']} nodes, pool "
                   f"{st['pool_bytes'] / 2**20:.1f} MiB; {GRAPH_FRAMES} replayed frames with a "
                   f"camera move bitwise the eager frames; the port's kernel nodes {nodes}, an "
                   f"eager frame's launches, and the device ran them in each of "
                   f"{GRAPH_PROFILED} bare replays; "
                   f"ms/frame eager {', '.join(f'{x:.3f}' for x in ms['eager'])}, graphed "
                   f"{', '.join(f'{x:.3f}' for x in ms['graph'])}")
    return {"warmup_s": warm_s, **st, "launches_a_replay": nodes, "shading": shading,
            "ms_eager": ms["eager"],
            "ms_graph": ms["graph"], "lane_order": pt.lane_order}


def _graph_scene(name: str, scene_s, scene_t, cam_s):
    """(scene, camera) of a graph path's scene name."""
    if name == "cornell":
        return cornell()
    if name == "multiroom":
        return multiroom()
    if name == "soup:100000":
        return scene_s, cam_s
    if name == "soup:100000 forest":
        return scene_t, cam_s
    if name == "soup:10000":
        return load_scene("soup:10000")[:2]
    from pbr_tpu_torch.tools.band_table import build_row

    return build_row("soup_plain", 10_001)


def graph_bench_check(name: str, kernels: tuple, dev, frames: int = 2) -> dict:
    """The bench's graphed step on scene ``name`` at SIZE², forward and
    backward, by ``tools/graph_steps.py::measure`` (one round of
    ``frames`` frames): ``bench.FrameStep`` bitwise ``bench.step`` and
    ``bench.step_grads``, the eager step's launches ``frames`` times the
    graph's kernel nodes of the port, and the device's run of them over
    ``frames`` bare replays (torch.profiler) the same. Here
    also: all 28 gradients, and ``kernels`` each once a bounce of a replay
    and no other."""
    out = {}
    depth = bench_settings(SIZE).max_total_depth
    for fwd_only in (True, False):
        mode = "forward" if fwd_only else "fwd+bwd"
        row = graph_steps.measure(name, fwd_only, SIZE, frames, 1, dev)
        if not fwd_only and row["grads"] != 28:
            raise AssertionError(f"graph bench {name}: {row['grads']} parameters")
        _expect(f"graph bench {name} {mode}", row["launches_a_replay"],
                dict.fromkeys(kernels, depth))
        # A forward frame, or one that autograd records: the backward too.
        _shade_pattern(f"graph bench {name} {mode}", row["launches_a_replay"], 1,
                       bench_settings(SIZE), backward=not fwd_only)
        _compact_pattern(f"graph bench {name} {mode}", row["launches_a_replay"], 1,
                         backward=not fwd_only)
        phase("graph", f"bench {name} {mode}: {frames} replayed frames bitwise the eager step"
                       f"{'' if fwd_only else ' (loss and all 28 gradients)'}; capture "
                       f"{row['capture_s']:.3f} s, {row['nodes']} nodes, pool "
                       f"{row['pool_bytes'] / 2**20:.1f} MiB; over {frames} replays the device "
                       f"ran {row['device_launches']} of the port's kernels; ms/frame "
                       f"eager {row['ms_eager'][0]:.3f}, graphed {row['ms_graph'][0]:.3f}; "
                       f"device ms/frame eager {row['device_ms_eager']:.3f}, graphed "
                       f"{row['device_ms_graph']:.3f}")
        out[mode] = row
        torch.cuda.empty_cache()
    return out


def graph_fit_check(name: str, size: int, dev) -> dict:
    """``fit``'s graphed steps (``app.fit_steps``) on scene ``name`` at
    ``size``² (``_fit_steps_bitwise``)."""
    import argparse

    settings = RenderSettings().replace(width=size, height=size, shadow_rays=1, brdf=0,
                                        max_depth=2, max_added_depth=0)
    scene, settings = app._load_scene(name, settings)
    args = argparse.Namespace(eye=None, center=None, size=size)
    from pbr_tpu_torch.utils.config import CameraConfig

    cam = app._camera_for(args, CameraConfig(), name).state()
    out = _fit_steps_bitwise(f"{name} {size}²", app.fit_problem(scene, settings, cam, dev))
    phase("graph", f"fit {name} {size}²: value_and_grad and loss_at, graphed, bitwise the "
                   f"eager step at 3 points (loss {out['loss']:.6f})")
    return out


def _fit_steps_bitwise(tag: str, prob) -> dict:
    """``app.fit_steps`` of ``prob`` at the CLI's starting albedos and at a
    second point: the loss and its gradient in kd bitwise the eager step's,
    and ``loss_at`` the same loss."""
    param = prob.ts.mat_kd
    kd0 = param.detach().clone()
    noise = torch.tensor(np.random.RandomState(0).uniform(-0.3, 0.3, kd0.shape[1]),
                         dtype=torch.float32, device=kd0.device)
    start = kd0.clone()
    start[0] = torch.clamp(kd0[0] + noise, 0.0, 1.0)
    value_and_grad, loss_at = app.fit_steps(prob)
    for kd in (start, torch.clamp(start - 0.05, 0.0, 1.0), start):
        loss, g = value_and_grad(kd)
        g = g.clone()
        lo = loss_at(kd)
        with torch.no_grad():
            param.copy_(kd)
        param.requires_grad_(True)
        eager = prob.loss()
        (eager_g,) = torch.autograd.grad(eager, param)
        param.requires_grad_(False)
        if loss != float(eager.detach()) or lo != loss or not torch.equal(g, eager_g):
            raise AssertionError(f"graph fit {tag}: the graphed step differs from the eager "
                                 f"one (loss {loss} vs {float(eager.detach())}, loss_at {lo})")
    return {"loss": loss}


def graph_no_fallback_check(dev) -> None:
    """A step that reads the device from the host fails before its capture,
    naming the line of the read, and leaves nothing captured: no step runs
    eagerly in place of a graph."""
    x = torch.ones(4, device=dev)
    step = CapturedStep(lambda t: t * float(t.sum()), x, name="a step with a host read")
    try:
        step()
    except RuntimeError as e:
        if "chip_smoke.py" not in str(e) or step.graph is not None:
            raise AssertionError(f"graph: the failure names no line: {e}") from e
        phase("graph", f"a step with a host read raises: {str(e).splitlines()[0][:200]}")
        return
    raise AssertionError("graph: a step with a host read was run without a graph")


def graph_phase(dev, scene_s, scene_t, cam_s) -> dict:
    """A step with a host read raises (``graph_no_fallback_check``); every
    path of GRAPH_PATHS through ``graph_frame_check``, then the bench's
    graphed step on Cornell (K1) and soup:100000 (K8) and ``fit``'s on
    Cornell (64²) and multiroom (1024²): the captured steps of the port's
    three entry points, bitwise their eager steps."""
    t_phase = time.perf_counter()
    graph_no_fallback_check(dev)
    out = {"frames": {}}
    for tag, name, kw, kernels in GRAPH_PATHS:
        scene, cam = _graph_scene(name, scene_s, scene_t, cam_s)
        out["frames"][tag] = graph_frame_check(tag, scene, cam, dev, kernels, **kw)
        torch.cuda.empty_cache()
    out["bench"] = {n: graph_bench_check(n, kernels, dev) for n, kernels in
                    (("cornell", ("K1",)), ("soup:100000", ("K8", "K8 any-hit")))}
    torch.cuda.empty_cache()
    out["fit"] = {"cornell": graph_fit_check("cornell", FIT_SIZE, dev),
                  "multiroom": graph_fit_check("multiroom", SIZE, dev)}
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    phase("graph", f"phase took {out['seconds']:.1f} s")
    return out


# The bench runs of the bench phase: (tag, arguments, the kernels its
# timed steps launch once a bounce each, this script's path whose count of
# rays it must equal).
# The Cornell run takes the default frames a step (32), the other 4.
BENCH_RUNS = (
    ("cornell", ["--iters", "3"], ("K1",), "cornell"),
    ("soup:100000", ["--scene", "soup:100000", "--fwd-only", "--iters", "3",
                     "--frames-per-step", "4"], ("K8", "K8 any-hit"), "soup:100000 K8"),
)
BENCH_DEFAULT_FRAMES = 32
BENCH_TIMEOUT = 300
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
# The bench's backward step held card against CPU: (scene, the kernels the
# card's step launches, once a bounce of each frame), at BENCH_STEP_SIZE²
# over BENCH_STEP_FRAMES frames from seed0 1.
BENCH_STEPS = (("cornell", ("K1",)), ("soup:100000", ("K8", "K8 any-hit")))
BENCH_STEP_SIZE = 64
BENCH_STEP_FRAMES = 2


def bench_step_check(name: str, kernels: tuple, dev) -> dict:
    """``bench.step_grads`` (bench.py's backward step: the gradients to
    every material and light parameter and every camera field, summed over
    BENCH_STEP_FRAMES frames) on the bench's scene ``name`` at
    BENCH_STEP_SIZE², the card's against the CPU's (the plain versions),
    both with the card's settings and over the pixels whose colours agree
    within 1e-3 in every frame (at least 99%; ``_grads_agree``'s mask):
    the loss within 1e-4 of its magnitude and every parameter within 1e-3
    of its largest magnitude, as ``_grads_agree`` holds them (the CPU's
    through the plain adjoints). The card's step launches ``kernels``, each
    once a bounce of each frame, no other search, and the shading kernels
    with their backward (``_shade_pattern``)."""
    tag = f"bench step {name}"
    size, frames = BENCH_STEP_SIZE, BENCH_STEP_FRAMES
    card = bench.differentiable(bench.bench_scene(name, size, dev))
    host = bench.differentiable(bench.bench_scene(name, size, "cpu"))
    host = host._replace(settings=card.settings)
    if not torch.equal(card.pixel_ids.cpu(), host.pixel_ids):
        raise AssertionError(f"{tag}: the lanes' pixels differ between card and CPU")
    col = []
    with torch.no_grad():
        for b in (card, host):
            col.append(np.stack([trace_rays(b.scene, b.cam, b.settings, b.pixel_ids,
                                            fold(1, k)).color.stack().cpu().numpy()
                                 for k in range(frames)]))
    agree = (np.abs(col[0] - col[1]).max(axis=2) <= 1e-3).all(axis=0)
    if agree.mean() < 0.99:
        raise AssertionError(f"{tag}: {size}² colours, card vs CPU: only {agree.mean():.4%} "
                             f"of pixels agree")
    w = torch.tensor(agree.astype(np.float32))
    zero_counts()
    loss_c, g_c = bench.step_grads(card.scene, card.cam, card.settings, card.pixel_ids, 1,
                                   frames=frames, weights=w.to(dev))
    torch.cuda.synchronize()
    launched = {k: v for k, v in counts().items() if v}
    _expect(tag, launched, dict.fromkeys(kernels, frames * card.settings.max_total_depth))
    _shade_pattern(tag, launched, frames, card.settings, backward=True)
    _compact_pattern(tag, launched, frames, card.settings, backward=True,
                     batch=card.pixel_ids.shape[0])
    loss_h, g_h = bench.step_grads(host.scene, host.cam, host.settings, host.pixel_ids, 1,
                                   frames=frames, weights=w)
    loss_c, loss_h = float(loss_c), float(loss_h)
    if not np.isfinite(loss_c) or abs(loss_c - loss_h) > 1e-4 * abs(loss_h):
        raise AssertionError(f"{tag}: loss {loss_c} on the card, {loss_h} on the CPU")
    if set(g_c) != set(g_h):
        raise AssertionError(f"{tag}: parameters {sorted(g_c)} vs {sorted(g_h)}")
    worst = 0.0
    for pname, ref in g_h.items():
        a, r = g_c[pname].cpu().double(), ref.double()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{tag}: gradient {pname} is not finite on the card")
        tol = 1e-3 * float(r.abs().max()) + 1e-5
        err = float((a - r).abs().max())
        worst = max(worst, err / tol)
        if err > tol:
            raise AssertionError(f"{tag}: {size}² gradient {pname}, card vs CPU: max |diff| "
                                 f"{err} > {tol}")
    phase("bench", f"{tag}: {size}² step_grads over {frames} frames, card vs CPU over the "
                   f"{agree.mean():.4%} of pixels whose colours agree: loss {loss_c:.4f} vs "
                   f"{loss_h:.4f}, all {len(g_h)} parameters within 1e-3 of their largest "
                   f"magnitude (worst at {worst:.3f} of that bound); launches {launched}")
    return {"size": size, "frames": frames, "agree": float(agree.mean()), "loss": loss_c,
            "loss_cpu": loss_h, "params": len(g_h), "worst_of_bound": worst, "launches": launched}


def bench_phase(dev) -> dict:
    """The bench's backward step on the card against the CPU for each of
    ``BENCH_STEPS`` (``bench_step_check``); then ``python -m
    pbr_tpu_torch.bench`` in a subprocess from the checkout's root for
    each of ``BENCH_RUNS``, as the benchmark runs it: exit code 0; the last
    line exactly bench.py's keys, unit rays/s, a finite positive value; a
    log line of the frame step's capture; the launch line the run's
    kernels, each once a bounce of each frame of each timed step (one
    replay of the frame's graph a frame, its kernel nodes read from the
    driver), and nothing else; rays a frame (path segments and shadow
    rays) equal to this script's count of the same scene at seed 0
    (``PATH_RAYS``; the count depends on neither lane order nor schedule
    while no lane drops)."""
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    out = {"step": {name: bench_step_check(name, kernels, dev) for name, kernels in BENCH_STEPS}}
    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent
    depth = bench_settings(SIZE).max_total_depth
    for tag, argv, kernels, path in BENCH_RUNS:
        cmd = [sys.executable, "-m", "pbr_tpu_torch.bench", *argv]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                              timeout=BENCH_TIMEOUT)
        sec = time.perf_counter() - t0
        for line in proc.stderr.splitlines():
            if line.startswith("[bench] "):
                phase("bench", f"{tag}: {line[len('[bench] '):]}")
        if proc.returncode != 0:
            raise AssertionError(f"bench {tag}: exit code {proc.returncode}:\n"
                                 f"{proc.stderr[-4000:]}")
        last = json.loads(proc.stdout.strip().splitlines()[-1])
        value = last.get("value")
        if set(last) != BENCH_KEYS or last["unit"] != "rays/s" \
                or not isinstance(value, (int, float)) or not np.isfinite(value) or value <= 0:
            raise AssertionError(f"bench {tag}: last line {last}")
        iters = int(argv[argv.index("--iters") + 1])
        k = (int(argv[argv.index("--frames-per-step") + 1]) if "--frames-per-step" in argv
             else BENCH_DEFAULT_FRAMES)
        launched = json.loads(re.search(r"\[bench\] launches over \d+ timed steps: (\{.*\})",
                                        proc.stderr).group(1))
        # One replay of the frame's graph a frame: each kernel once a bounce.
        _expect(f"bench {tag}", launched, dict.fromkeys(kernels, iters * k * depth))
        # Forward frames: K11 and K12; frames that autograd records: their
        # backward too.
        _shade_pattern(f"bench {tag}", launched, iters * k, bench_settings(SIZE),
                       backward="--fwd-only" not in argv)
        _compact_pattern(f"bench {tag}", launched, iters * k, backward="--fwd-only" not in argv)
        if f"({k} frames a step)" not in proc.stderr or \
                "[bench] CUDA graph of one frame: captured in" not in proc.stderr:
            raise AssertionError(f"bench {tag}: no capture of the frame step in its log")
        m = re.search(r"\[bench\] \d+x\d+: (\d+) path segments \+ (\d+) shadow rays",
                      proc.stderr)
        rays = (int(m.group(1)), int(m.group(2)))
        if rays != PATH_RAYS[path]:
            raise AssertionError(f"bench {tag}: (path segments, shadow rays) {rays} a frame, "
                                 f"path {path!r} counted {PATH_RAYS[path]}")
        phase("bench", f"{tag}: {' '.join(argv)} in {sec:.1f} s: {last['metric']} = "
                       f"{value} rays/s; launches {launched}; {sum(rays)} rays a frame, as "
                       f"path {path!r} counts them")
        out[tag] = {"argv": argv, "seconds": sec, "result": last, "launches": launched,
                    "rays": sum(rays)}
    sec = time.perf_counter() - t_phase
    phase("bench", f"phase took {sec:.1f} s")
    out["seconds"] = sec
    return out


# The port's kernels' names, as the profiler shows them.
PORT_KERNELS = ("intersect", "gated_kernel", "slotted_kernel", "masked_kernel", "rows_kernel",
                "packet_kernel", "chain_kernel", "slab_kernel", "walk_kernel",
                "phong_clusters_kernel", "gen_rays_kernel", "shade_kernel",
                "gen_rays_bwd_kernel", "shade_bwd_kernel", "row_gather_kernel")


def profile_phase(tag: str, pt: PathTracer, cam, step=None) -> None:
    """Device time by kernel over one eager frame (``eager_frame``: a
    graph's replay loses profiler records), or over one call of ``step``
    (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if step is None:
            eager_frame(pt, cam, 99)
        else:
            step()
        torch.cuda.synchronize()
    # Kernel rows only: an operator's row carries its kernels' time too.
    rows = [(e.key, e.device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    total = sum(r[1] for r in rows)
    ours = sum(r[1] for r in rows if any(k in r[0] for k in PORT_KERNELS))
    phase("profile", f"{tag}: device time over one {'frame' if step is None else 'step'}: "
                     f"{total / 1e3:.3f} ms in {sum(r[2] for r in rows)} kernel launches; "
                     f"the port's kernels {ours / 1e3:.3f} ms")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
        phase("profile", f"{us / 1e3:9.3f} ms {count:6d}x {key[:100]}")


def _device_launches(fn) -> tuple:
    """(kernel launches, their device ms, the port's kernels' ms, wall ms)
    over one call of ``fn``: torch.profiler with CUDA activity only, read
    from its raw events (a Phong frame launches over a million kernels,
    too many for its per-operator tables)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ev = [(e.name(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA and not e.name().startswith(("Memcpy", "Memset"))]
    ours = sum(ns for name, ns in ev if any(k in name for k in PORT_KERNELS))
    return len(ev), sum(ns for _, ns in ev) / 1e6, ours / 1e6, wall


def main() -> None:
    profile = "--profile" in sys.argv[1:]
    smi = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()

    scene, cam = cornell()
    k1 = cornell_kernel_phase(scene, cam, dev)
    oracle_phase("cornell", scene, cam, dev)
    corn = cornell_path_phase(scene, cam, dev, k1, profile)
    nee_off = cornell_nee_off_phase(scene, cam, dev)

    scene_m, cam_m = multiroom()
    oracle_phase("multiroom", scene_m, cam_m, dev)
    mr = multiroom_path_phase(scene_m, cam_m, dev, profile)
    mk = multiroom_kernel_phase(scene_m, cam_m, dev, mr["pt"])
    mr_launches, mk_times, mk_errs, mk_bounds, mr_k1 = (mr["launches"], mk["times"], mk["errs"],
                                                        mk["bounds"], mr["k1_launches"])
    grad = multiroom_grad_phase(scene_m, cam_m, dev, mr["pt"], profile)
    lin = lin_path_phase(scene_m, dev, mk)
    mc = multiroom_cull_phase(scene_m, cam_m, dev, mr["pt"])
    msw = multiroom_sweep_phase(scene_m, cam_m, dev, mr["pt"])
    del mr, mk
    band_golden_phase(dev)

    scene_s, cam_s = soup()
    oracle_phase("soup:100000", scene_s, cam_s, dev, size=64)
    sp = soup_path_phase(scene_s, cam_s, dev, profile)
    sk = soup_kernel_phase(dev, sp["pt"], cam_s)
    k4_first, sp_launches, sp_k1 = sp["first"], sp["launches"], sp["k1_launches"]
    del sp
    sw = sweep_path_phase(scene_s, cam_s, dev, k4_first, profile)
    swk = sweep_kernel_phase(dev, sw["pt"], cam_s)
    del sw["pt"]

    t0 = time.perf_counter()
    scene_t = scene_s._replace(forest=build_forest(scene_s.tris))
    phase("soup:100000", f"forest built in {time.perf_counter() - t0:.3f} s: "
                         f"{len(scene_t.forest.bvhs)} sub-trees of {scene_t.forest.chunk_size} "
                         f"faces, {scene_t.forest.bvhs[0].count} nodes each (padded); main tree "
                         f"{scene_t.bvh.count} nodes, packet_hbm_fits "
                         f"{cb.packet_hbm_fits(scene_t.bvh)}")
    tree_oracle_phase(scene_t, cam_s, dev)
    tp = tree_path_phase(scene_t, cam_s, dev, k4_first, profile)
    s10 = soup10k_phase(dev)
    tk = {**tree_kernel_phase(dev, tp["k7"]["pt"], cam_s, s10["pt"], s10["cam"]),
          **tp["k8"]["shadow"]}
    del tp["k7"]["pt"], s10["pt"]
    torch.cuda.empty_cache()
    sh = shade_phase(dev, scene_s, cam_s)
    print(json.dumps({"shade": sh}), flush=True)
    torch.cuda.empty_cache()
    print(json.dumps({"graph": graph_phase(dev, scene_s, scene_t, cam_s)}), flush=True)

    print(json.dumps({"bench": bench_phase(dev)}), flush=True)

    ap = {"device": smi, "render": app_render_phase(cam, dev)}
    app_denoise_phase(scene, cam, dev)
    ap["fit"] = app_fit_phase(dev)
    ap["gemm"] = app_gemm_phase(scene, cam, dev, k1, corn["times"]["K1'"][0])
    ap["view"] = app_view_phase(dev)
    print(json.dumps({"app": ap}), flush=True)
    ph = phong_phase(cam, dev)
    print(json.dumps({"device": smi, "phong": ph, "sharded": sharded_phase(dev)}), flush=True)
    phase("done", f"all phases passed on {smi}")

    t = {**corn["times"], **mk_times, **mc["times"], **sk["times"], **msw["times"],
         **swk["times"], **{k: (v["ms"], v["plain_ms"]) for k, v in tk.items()}}
    # K9 and K10 on the 1M camera rays, the main path's first pass; K9
    # any-hit on its first shadow leg.
    phong = {"K9": ph["passes"]["K9 camera"], "K10": ph["passes"]["K10 camera"],
             "K9 any-hit": ph["passes"]["K9 any-hit 0"]}
    t.update({k: (v["ms"], v["plain_ms"]) for k, v in phong.items()})
    # K11 and K12 on their main path's bounce 0 (Cornell: K11, K12; the
    # 'bvh' path of soup:100000: K12 pre and post), bitwise their plain
    # versions on every call of the shade phase's frames; K11 bwd and K12
    # bwd on Cornell's backward step (bounce 0), their launches those of
    # the multiroom forward+backward path's STEPS steps.
    t.update({k: (v["ms"], v["plain_ms"]) for k, v in sh["times"].items()})
    bounds = {**corn["bounds"], **mk_bounds,
              **{k: v[2] for times in (mc["times"], sk["times"], msw["times"], swk["times"])
                 for k, v in times.items() if len(v) == 3},
              **{k: (v["bound_ms"], v["bound_by"]) for k, v in tk.items()},
              **{k: (v["bound_ms"], v["bound_by"]) for k, v in phong.items()},
              **{k: v["bound"] for k, v in sh["times"].items()}}
    errs = {**k1["errs"], **mk_errs, **mc["errs"], **sk["errs"], **msw["errs"], **swk["errs"],
            **{k: v["err"] for k, v in tk.items()}, **{k: v["err"] for k, v in phong.items()},
            **sh["errs"]}
    fo = tp["forest"]["launches"]
    # (instance, source, launches on its path, frames of the path's run
    # that the count covers: the timed frames, or one frame; the linear
    # form's path is one call of its entry point, counted as one frame)
    rows = [
        ("K1", K12_SOURCE, corn["launches"]["K1"], FRAMES),
        ("K1'", K12_SOURCE, nee_off["K1'"], 1),
        ("K2", K12_SOURCE, lin["K2"], 1),
        ("K2'", K12_SOURCE, lin["K2'"], 1),
        ("K1 (multiroom)", K12_SOURCE, mr_k1, 1),
        ("K1 (soup:100000)", K12_SOURCE, sp_k1, 1),
        ("K3", K3_SOURCE, mr_launches["K3"], FRAMES),
        ("K3 any-hit", K3_SOURCE, mr_launches["K3 any-hit"], FRAMES),
        ("K4", K4_SOURCE, sp_launches["K4"], FRAMES),
        ("K4 any-hit", K4_SOURCE, sp_launches["K4 any-hit"], FRAMES),
        ("K4m", K4_SOURCE, mc["launches"]["K4m"], 1),
        ("K4m any-hit", K4_SOURCE, mc["launches"]["K4m any-hit"], 1),
        ("K5", K5_SOURCE, sw["launches"]["K5"], FRAMES),
        ("K5 any-hit", K5_SOURCE, sw["launches"]["K5 any-hit"], FRAMES),
        ("K5m", K5_SOURCE, msw["launches"]["K5m"], 1),
        ("K5m any-hit", K5_SOURCE, msw["launches"]["K5m any-hit"], 1),
        ("K6 nearest", K67_SOURCE, fo["K6 nearest"], 1),
        ("K6 NEE", K67_SOURCE, s10["launches"]["K6 NEE"], 1),
        ("K6 any-hit", K67_SOURCE, fo["K6 any-hit"], 1),
        ("K6 seeded", K67_SOURCE, fo["K6 seeded"], 1),
        ("K6 seeded any-hit", K67_SOURCE, fo["K6 seeded any-hit"], 1),
        ("K7 nearest", K67_SOURCE, tp["k7 off"]["K7 nearest"], 1),
        ("K7 NEE", K67_SOURCE, tp["k7"]["launches"]["K7 NEE"], FRAMES),
        ("K8", K8_SOURCE, tp["k8"]["launches"]["K8"], FRAMES),
        ("K8 any-hit", K8_SOURCE, tp["k8"]["launches"]["K8 any-hit"], FRAMES),
        ("K9", K9_SOURCE, ph["path"]["launches"].get("K9", 0), PHONG_FRAMES),
        ("K9 any-hit", K9_SOURCE, ph["path"]["launches"].get("K9 any-hit", 0), PHONG_FRAMES),
        ("K10", K10_SOURCE, ph["path"]["launches"].get("K10", 0), PHONG_FRAMES),
        ("K11", SHADE_SOURCE, corn["launches"]["K11"], FRAMES),
        ("K12", SHADE_SOURCE, corn["launches"]["K12"], FRAMES),
        ("K12 pre", SHADE_SOURCE, tp["k8"]["launches"]["K12 pre"], FRAMES),
        ("K12 post", SHADE_SOURCE, tp["k8"]["launches"]["K12 post"], FRAMES),
        ("K11 bwd", SHADE_BWD_SOURCE, grad["launches"]["K11 bwd"], STEPS),
        ("K12 bwd", SHADE_BWD_SOURCE, grad["launches"]["K12 bwd"], STEPS),
        ("K13", COMPACT_SOURCE, corn["launches"]["K13"], FRAMES),
        ("K14", COMPACT_SOURCE, corn["launches"]["K14"], FRAMES),
        ("K13 bwd", COMPACT_SOURCE, grad["launches"]["K13 bwd"], STEPS),
        ("K14 bwd", COMPACT_SOURCE, grad["launches"]["K14 bwd"], STEPS),
    ]
    # No one PyTorch call computes a nearest-hit search, a BVH walk or a
    # bounce's shade: library_ms is null but for compaction's (one call a
    # field, ``_compact_library``).
    if len(rows) != 38:
        raise AssertionError(f"expected 38 kernel rows, got {len(rows)}")
    idle = [name for name, _, n, _ in rows if name in COMPACT_KERNELS and not n]
    if idle:
        raise AssertionError(f"{idle} launched no time on their main paths")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src,
        "replaces": REPLACES[name] if name in REPLACES else REPLACES[name.split()[0]],
        "launches": n, "frames": frames, "launches_per_frame": n / frames,
        "max_abs_err": errs[name],
        "ms": t[name][0], "plain_ms": t[name][1],
        "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        "library_ms": sh["times"].get(name, {}).get("library_ms"),
        # K10 beside its row: the yardstick bound, and its launches in
        # the Phong golden's frames under PHONG_OLD_MIN_RAYS, where it runs
        # whatever the band.
        **({"bound_jax_ms": phong["K10"]["bound_jax_ms"],
            "bound_jax_by": phong["K10"]["bound_jax_by"],
            "golden_launches": ph["golden"]["launches"]["K10"],
            "golden_frames": ph["golden"]["frames"]} if name == "K10" else {}),
    } for name, src, n, frames in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
