#!/usr/bin/env python3
"""Drives the PyTorch port (volume_renderer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out FILE] [--parent DIR]

Phases, one JSON line each; any failure raises and exits nonzero:

1. device:  the card, its power limit, and the build of every kernel
            source (one nvcc each, started together), with the registers,
            spills and resulting blocks an SM that ptxas reports for each
            kernel instantiation (K2L's paired, unpaired and unpacked forms,
            K6L and the lookup gradient segment among them). No kernel may
            spill.
2. goldens: the five tests/goldens scenes through VolumeRenderer on the
            card, held against the committed images.
3. kernel_vs_plain: the forward march kernel against its plain PyTorch
            version (ops/forward.py) on the card at 24^3 / 256x192, per
            mode, unlit (K1) also with absorption of another shape, lit
            (K4) on an anisotropic (36, 24, 64) volume and on a 48^3 one
            seen near an axis (taps on faces and edges), and lookup (K5)
            packed with absorption aliased, separate with reflection
            aliased, and of another shape, and unpacked with gradient
            volumes of another shape. K1 and K4 must equal their plain
            versions exactly, here and wherever else they are compared.
4. grads_vs_plain: the backward march kernel through voxel_grads_fast (K3
            unlit, K6 lit) and transfer_grads_fast (K2) against its plain
            version (ops/vjp.py:replay_backward) at 24^3 / 256x192, K3
            also with absorption of another shape, K6 on the two lit
            scenes of phase 3, unlit K2 packed (absorption separate and of
            emission's shape) and not (aliased, of another shape), K6L and
            K2L on K5's noisy scene (packed with absorption aliased, packed
            with two lights and reflection aliased, unpacked with gradient
            volumes of another shape, packed with absorption and reflection
            of emission's shape: K6L's float2 accumulator and K2L's paired
            form, and with reflection of another shape: K2L's unpaired
            form), every gradient key (K3's grids within 1e-5 of scale,
            every other key within 1e-4, the gradient volumes' grids
            included), and the form each K2L call launched
            (LAUNCHES_BY_FORM).
5. main_path: VolumeRenderer.render() at 256^3 / 512^2 for the unlit (K1),
            lit on-the-fly (K4) and lit lookup (K5) flagship scenes, with
            the launch counts set to 0 just before and read just after;
            each image is held against the plain version on the whole image.
6. train_main_path: at 256^3 / 512^2, three Adam steps of
            train.train_step_fast on the unlit scene (K1 + K3 a step), on
            the lit one (K4 + K6) and on the lit lookup one (K5 + K6L), and
            three-step transfer-parameter fits through transfer_grads_fast
            (K1 + K2, K5 + K2L: K2L's paired form, counted by form), counted
            like phase 5. The loss must fall.
            Before the counted steps, the first step's gradients are held
            against the plain replay on a 64-row band (rows 224-287), and K2,
            lit K2 and K2L against the replays of the K3, K6 and K6L steps' bands
            (one plain replay a scene); K3, K6 and K6L are held there
            twice: launched over the whole image with the cotangent zero
            outside the band, and over the band alone.
7. timing:  the forward kernel (CUDA events, warm, median of 5) at
            256^3 / 512^2 and 512^3 / 1024^2 (K1, K4, K5; the plain version
            as phase 5 ran it at 256^3, at 512^3 on a 64-row band through
            the middle for K1 and K5), with rays/s, the march samples the
            rays took and the bound, the kernel over a band of 64 rows
            alone (rows 384-447 at 512^2, against the whole launch's rows
            to the bit; the plain band at 1024^2, against its plain rows),
            K5's pack alone (its forward includes it) and, at
            256^3 / 512^2, the gather model (gather_footprint) of its
            float4 corner loads against float32 ones on a 64-row band;
            then the forward + backward pair, the backward kernel
            alone and the whole training step (a transfer-fit step for K2)
            for K3, K6, K2, lit K2, K6L and K2L at 256^3 / 512^2 and K3 and
            K2 at 512^3 / 1024^2 (K2 without a plain band, K3's of 64 rows),
            with the bound, K3's atomic adds a sample at 256^3 / 512^2,
            counted from the plain march's positions (march_flushes), K6L's
            (march_scatter_adds: the values added a sample, the reductions
            by width, float4, float2 and scalar, and the 32-byte sectors
            they reach), and K2's pack alone and, at
            256^3 / 512^2, the gather model of its float2 corner loads;
            K2L's kernel alone (K5's pack and its pair made outside the
            timed call), each pack alone, the gather model of the pair's
            float2 corner loads and the tail factor of its blocks.

8. bricks_vs_plain: the z-brick kernels (K7) at 24^3 / 256x192, 4 bricks:
            each launch form on every brick (phase 1 opacity and entry
            record, phase 2 contribution and exit opacity, the gradient
            segment's padded grids and parameter sums) against its plain
            pass (ops/brick_march.py) on the same inputs, on a band of 96
            rows through the middle (the kernels launched on the whole
            image, the cotangent zero outside the band), for cameras whose
            rays rise in z, fall in z and do both, and for an absorption
            volume of another shape than emission's; the records and the
            forward phases must equal their plain versions to the bit; the
            bricked image against the single-device kernel's. Then the lit
            forms at 32^3 / 96x64 on a band of 32 rows (the plain lit passes
            cost thousands of launches a step): lit phase 2 equal to its
            plain pass to the bit on an on-the-fly scene (two lights, rays
            of both signs of dz), within K5's tolerance on lookup ones (the
            packed window, also equal to the unpacked form to the bit;
            gradient volumes of another shape, unpacked, on the last brick);
            the lit gradient segment's grids within 1e-5 of scale, its other
            keys 1e-4, and so the lookup gradient segment's (packed and
            unpacked, 5 % seeded noise) on the last brick; the bricked image
            and the slab sweep against K4's and K5's. Then every form over a
            band (a rank of a rows x bricks mesh marches one): two bands of
            96 rows at 24^3 / 256x192, 4 bricks, on the four unlit cameras
            and on a lit on-the-fly (two lights) and a lit lookup (packed)
            scene, each band equal to the whole launch's rows to the bit
            (the gradient segments' bands, the lookup segment's too, summed
            within 1e-5 of scale) and held against its plain band
            pass, as the whole launches are, on every brick of one unlit
            camera and on the lit scenes' last brick.
9. bricks_main_path: at 256^3 / 512^2 on the noisy K3 scene, the launch
            forms on the last brick against their plain passes on a 64-row
            band (every brick at 24^3 in phase 8); then, counted
            like phase 5, render_forward_bricked_fast with 4 and 8 bricks,
            also on a dense scene with opacity threshold 0.3 (rays die
            mid-volume), one voxel_grads_bricked_fast call and three Adam
            steps of train_step_fast_bricked. Expected launches: 2 a brick
            and render, 3 a brick and gradient call or step. Images and
            first-step gradients are held against the single-device kernels,
            and the loss must fall.
10. bricks_timing: with 4 bricks, each launch form over all bricks, the
            bricked forward, forward + backward and training step (CUDA
            events, warm, median of 5) beside the single-device kernels on
            the same scene, with the samples each phase took and the bound;
            the atomic adds a sample of the gradient segment's corner carry
            (corner_flushes) and the corner loads a sample that a per-ray
            corner cache would make for phase 1 (corner_loads), counted from
            the plain walk; the launch
            forms, phase 1's loads and the bricked forward on the dense
            scene too, where the walk to a brick was a larger share of a
            ray's work. Then bricks_lit_main_path, counted like phase 5: the
            lit bricked render of the noisy K4 scene and of the noisy K5
            scene, a lit bricked gradient call and a lit bricked Adam step
            on each (phase 1, lit phase 2 and the lit or the lookup gradient
            segment a brick), against K4, K5, K6's and K6L's
            voxel_grads_fast (the lookup step's gradients within 1e-5 of
            scale for the cotangent of its bricked image); lit phase 2 of
            both scenes and the
            lit segment of the K4 scene on the last brick against their plain
            passes on 32 rows through the middle, held as in phase 8; and
            the lit forms over all bricks timed with their samples and bound
            (the lookup gradient segment too, with its atomic adds a sample
            from the plain walk, by width and with their sectors,
            lookup_scatter_adds;
            and the lit bricked forwards and Adam steps), the lookup form's
            window pack alone, the tail factors of lit phase 2's launches
            and of K4's and K5's by block shape (tail_factor, from their
            steps planes), and the lit segment's atomic adds a sample
            (lit_corner_flushes).
11. parent_vs_new, only with --parent DIR: DIR holds another version of
            the port's package (e.g. the parent commit's, unpacked with git
            archive). Timed in turns, DIR's, the checkout's, the checkout's,
            DIR's, each version in a process of its own that builds and
            imports it and runs its turns when asked (the other waits), a
            median of 5 each: K1, K4 and K5 (256^3 / 512^2,
            512^3 / 1024^2; the images must be equal; K5's pack alone), K3
            and K6 (the backward alone, forward + backward, the training
            step, 256^3 / 512^2), K2 (the same and its pack, unlit at
            256^3 / 512^2 and 512^3 / 1024^2, lit at 256^3 / 512^2; the
            per-ray planes and gradients must be equal) and K7 with 4
            bricks at 256^3 / 512^2 (each
            launch form over all bricks, phase 2 alone from phase 1's
            outputs, phase 1 also on the dense scene; the bricked forward,
            forward + backward and training step; the host's time in phase
            2's calls, in their record checks and in the bricked forward;
            the bricked images, every brick's exit opacity, and phase 1's
            opacities and entry records on both scenes must be equal), and
            the lit K7 forms with 4 bricks at 256^3 / 512^2 (lit phase 2 on
            K6's noisy scene and on K5's, its pack included; the lit
            gradient segment; the lit bricked forwards and training step;
            every brick's lit contribution and exit opacity and the lit
            bricked images must be equal, the lit segment's grids within
            1e-5 of scale), and K6L and the lookup gradient segment on K5's
            noisy scene (K6L's backward alone, forward + backward and
            train_step_fast at 256^3 / 512^2; the lookup segment over 4
            bricks and the lookup bricked training step; every turn's
            grids within 1e-5 of scale of the parent's first turn's), and
            K2L on K5's noisy scene at 256^3 / 512^2 (the backward call, the
            kernel alone, forward + backward, the transfer-fit step, each
            pack; the per-ray planes and gradients must be equal). The
            lookup part alone, a process a version, with a reference the
            first writes, and the K2L part alone:
              for d in P N N P; do echo lookup | python3 chip_smoke.py \
                  --turn --repo $d --grids-ref lookup_ref.pt; done
              for d in P N N P; do echo k2l | python3 chip_smoke.py \
                  --turn --repo $d; done
12. dp_vs_single: rays-DP (parallel/pallas_dp.py) at 128^3 / 256x192
            with 5 bands on the one card, the last one shorter: the K1, K4
            and K5 band launches joined must equal the single launch's image
            bit for bit, and the K3, K6 and K6L gradients summed over the
            bands its gradients (grids within 1e-5 of scale, other keys
            1e-4; lit factor_reflection nonzero), also for an unlit scene with a
            reflection volume of its own, whose grid the bands share zeroed;
            the memory each DP backward call takes at its peak must stay
            within its grids and half a grid (K6L's: with its pack and its
            accumulators).
13. dp_main_path: at 256^3 / 512^2 with make_mesh(4), counted like phase 5:
            render_forward_fast_sharded on the K1, K4 and K5 scenes (4
            launches a render, K5's pack made once a render), three Adam
            steps of train_step_fast_sharded unlit (4 K1 + 4 K3 a step), lit
            (4 K4 + 4 K6) and lit lookup (4 K5 + 4 K6L), the loss falling
            and the first step's
            gradients held against voxel_grads_fast as in phase 12; one
            train_step_sharded step at 32^3 / 64^2 on 2 bands against
            train.train_step; a 2 x 2 rows x bricks render_forward_bricked
            (plain passes) at 32^3 / 64x48 against the K4 kernel. Then the
            DP forward, backward and step beside the single-device ones
            (CUDA events, warm, median of 5), the band launches alone on
            one stream, the host's time and each step's peak memory.
14. slab_vs_plain: the z-slab sweep through the K7 launch forms
            (ops/cuda_slab.py) at 128^3 / 256x192, slabbed (views of the
            grids on the card) and streamed (pinned host grids), 4 and 16
            slabs, and slabs of one row (d = 16, 16 slabs), for cameras whose
            rays rise in z, fall in z and do both: streamed equals slabbed
            bit for bit, both within 1e-5 of scale of the K1 image and, at
            the first slab count, within 2e-3 of the plain slab sweep
            (ops/slab.py: closed-form positions); the gradients of one
            slabbed and one streamed call against voxel_grads_fast (grids
            1e-5 of scale, other keys 1e-4); lit scenes (K4 with two lights
            and both signs of dz, K5) through the lit forms, 4 slabs:
            streamed equals slabbed, both within 1e-5 of scale of the
            kernel's image, the K4 scene's gradients against K6's.
15. slab_main_path, counted like phase 5: VolumeRenderer.render() at
            512^3 / 1024^2 with 1 GiB of pinned host grids under a
            memory_budget_bytes below them, planned streamed in 8 slabs:
            its peak device memory <= the plan's est_bytes <= the budget,
            K7 phase 1 and phase 2 alone (once a slab visited each), the
            bytes copied to the card and their GB/s, the image within 1e-5
            of scale of K1's; the slabbed sweep at 256^3 / 512^2 against its
            estimate (the planner picks "cuda" there: an unlit scene's
            kernel path holds less); three Adam steps of train_step_streamed
            and of train_step_planned (streamed) on the noisy K3 scene, the
            loss falling and the first step's gradients against
            voxel_grads_fast; train_step_planned without a budget ("cuda":
            K1 + K3); the facade with make_mesh(4) on the one card
            ("cuda_dp", K1's image bit for bit) and under a budget that
            picks "bricked"; the streamed and slabbed render and step beside
            the whole-grid kernels (CUDA events, warm, median of 5) with the
            host's time. Lit at 256^3 / 512^2: the facade under a budget
            below the whole grids plans the K4 scene streamed and the K5
            scene slabbed, K7 phase 1 and lit phase 2 alone, the image within
            1e-5 of scale of the kernel's, the peak within the estimate; one
            Adam step each of train_step_streamed, train_step_slabbed and
            train_step_planned (streamed) on the noisy K4 scene: the loss
            against train_step_fast's, the gradients against K6's for the
            cotangent of the sweep's own image; all timed. On the noisy K5
            scene, one Adam step each of train_step_fast (K5 + K6L),
            train_step_streamed and train_step_slabbed (the lookup gradient
            segment a slab), the sweeps' against K6L for the cotangent of
            their own image, timed, each step's peak within the planner's
            estimate of its tier; train_step_planned likewise, under the
            budget of the streamed tier's estimate (streamed, 8 slabs).

16. camera_grads (plain PyTorch on the card): render_fused(camera_grads=True)
            on rows 112-143 of 256^2 at 32^3 on the noisy K3 scene and on
            the noisy lit OTF scene, against
            torch.autograd of the fixed-trip march (render_rows(
            differentiable=True), its trip count cut to the band's longest
            march) on the same band: the rotation within 5e-3 of its scale,
            focal length, distance and x offset within 2e-3 (the JAX
            package's bounds), the images equal; the forward, backward and
            scan ms; then a 12-step Adam fit of the rotation, focal length
            and distance at 12^3 / 24^2, whose loss and pose error must fall.
17. oracle_vs_kernels: render_oracle on rows 224-287 of 512^2 at 256^3
            against the K1 image of render_forward_fast, and on rows 112-143
            of 256^2 at 64^3 against K4's and K5's (launched once each,
            counted; the oracle launches nothing), the facade's
            backend="oracle" against backend="forward" on the main path's
            scenes at 32^3 and 64 x 16, and bench.py's check (the 32^3 unlit
            flagship at 24^2), all within atol=3e-5, rtol=3e-4.
18. utils: utils.trace around one K1 render (the trace, written under
            out/chip_smoke/trace, must name march_kernel), Stopwatch
            and PhaseTimer around the same render beside its CUDA-event ms,
            and a checkpoint round trip (out/chip_smoke) of three
            train_step_fast steps' params and Adam state at 128^3: the
            fourth step's loss after a reload equals it without one, to the
            bit.
19. multi_process: parallel/multihost.run_demo on the card, a one-rank
            NCCL world and two ranks over gloo on the one card's tensors:
            every rank's rays-DP image of the lit flagship scene equal to
            render_forward_fast's, its plain and kernel DP steps' losses
            and gradients against train.train_step_sharded's and
            train_step_fast_sharded's on as many bands, its launches. In
            the same pool, at once, the bricked rehearsal (a z-brick a
            rank, the relay over the group; BRICK_WORLDS) in those two
            worlds at 12^3 / 16^2 and in four gloo ranks on the one card at
            256^3 / 512^2 (the flagship shell with 5 % seeded noise, unlit,
            lit and lit lookup, the last through the lookup gradient
            segment), and on rows x bricks meshes
            (global_mesh_2d: rank (r, b) marches brick b over band r, the
            bands joined over the brick's ranks), 2 x 1 at 12^3 / 16^2 and
            2 x 2, four gloo ranks, at 256^3 / 512^2, every world at once,
            each rank building only its own z-rows: a bricked render and
            one train_step_fast_bricked_ranks step a rank, with every
            rank's K7 launches (2 a render, 3 a step), ms and peak MiB,
            against the one-process bricked kernels on make_mesh(B) over
            the whole image (a rows x bricks image to the bit), timed alike
            (bricked_rehearsal_cells).
20. scaling_probe: utils/scaling_probe.measure at 256^3 / 512^2, the
            device time of render_forward_fast_sharded on 8 bands and of
            render_forward_bricked_fast on 8 bricks against 1, all on the
            one card (one card's total-work overhead, not a scaling
            measurement).
21. examples: every example of volume_renderer_tpu_torch/examples at its
            defaults on the card (the inverse ones with --steps 3), with
            the launches by mode each made; every image finite and not
            all zero (examples_phase).

Then the kernels line and, last, {"ok": true, "device": {...}}. It needs
the repository around it and a CUDA card; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import functools
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

DEVICE = "cuda"
# volume edge and image size of the phases
COMPARE = dict(volume=128, width=256, height=192)
# the kernels against their plain versions (phases 3, 4, 8): the plain march
# costs hundreds to thousands of launches a step whatever the rays, so its
# time follows the volume's edge, which the script's time limit sets
PLAIN = dict(volume=24, width=256, height=192)
MAIN = dict(volume=256, image=512)
BIG = dict(volume=512, image=1024, band=64)
# Training steps, the plain replay's band rows, and Adam's rates. Lit, the
# loss feels the emission grid through the normals (differences of
# neighbouring voxels, about 0.01 here) and the sharp LUT: its emission
# gradient is 1e5 times the unlit one, and steps of 2e-5 per voxel already
# scramble the normals and raise the loss.
TRAIN_STEPS, BAND = 3, 64
# rays-DP: bands at COMPARE's size (the last one shorter) and on the main path;
# the plain train_step_sharded and the rows x bricks render at a small size
DP_BANDS, DP_MAIN_BANDS = 5, 4
DP_SMALL = dict(volume=32, image=64, brick_image=(64, 48))
# With lookup gradient volumes the normals are volumes of their own, not
# differences of emission, but the lit terms make K3's rate overshoot: at
# 2e-3 the loss rose at the second step (K5's noisy scene at 256^3 / 512^2,
# an H100), at 5e-4 it fell at every one.
TRAIN_LR = {"K3": 2e-3, "K6": 2e-6, "K2": 1e-2, "K6L": 5e-4, "K2L": 1e-2}
# A scatter kernel's grids in one turn against another's (the lookup turn):
# atomic adds land in no fixed order, so within this share of each grid's
# scale, not to the bit.
TURN_GRID_TOL = 1e-5

# Published peaks of one H100 SXM at its full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# float32 operations of one march step, the least the step's function needs
# (a transcendental counts as one, index math as none), whatever a kernel
# does: one axis's coordinate is 2 (sub, mul), its corner and weight 6
# (mul, sub, floor, sub, 2 clamps), a lerp 3. A trilinear fetch at a
# position of its own is 39: three corners and 7 lerps. A volume of the
# emission's shape (every scene here, checked where the bounds are taken)
# is fetched at the emission's corners: 7 lerps.
_AXIS_COORD, _AXIS_CORNER, _LERP = 2, 6, 3
_COORDS, _BLEND = 3 * _AXIS_COORD, 7 * _LERP
_FETCH = 3 * _AXIS_CORNER + _BLEND
_STEP_UNLIT = _COORDS + _FETCH + 2 + 4 + 6 + 10 + 1 + 2 + 3  # + composite, t, stop, pos
# The six emission taps, half a voxel from the centre as in every timed
# scene: a tap's coordinate and corner on its own axis (the other two are
# the centre's, float for float) and 27 lerps, a lerp shared where it is the
# same one on the same floats (x taps 2 x 7; y taps 2 on the extra rows +
# 2 x 3; z taps 2 + 1 + 2), then the three differences.
_STEP_OTF_TAPS = 6 * (1 + _AXIS_COORD + _AXIS_CORNER) + 27 * _LERP + 6
_STEP_LOOKUP_TAPS = 3 * _BLEND
_STEP_NORMAL = 11 + 1  # + factor_reflection * re
_STEP_PER_LIGHT = 3 + 3 + 3 * 23 + 22 + _FETCH + 1 + 9


def flops_per_step(mode: str, ab_aliased: bool, re_aliased: bool, n_lights: int) -> int:
    ops = _STEP_UNLIT + (0 if ab_aliased else _BLEND)
    if mode != "K1":
        ops += (0 if re_aliased else _BLEND) + _STEP_NORMAL + 3 + n_lights * _STEP_PER_LIGHT
        ops += _STEP_LOOKUP_TAPS if mode == "K5" else _STEP_OTF_TAPS
    return ops


# float32 operations of one backward step, counted the same way: the
# replayed forward step with the under operator's cotangents and the per-ray
# sums. A scatter at the centre reuses the replay's corners: the weights'
# complements and y-z products are 7, the eight trilinear weights 8 more,
# and a cotangent spread over them 8 products and 8 atomic adds. Lit, the
# centre's and the six taps' emission scatters go to the 20 voxels of their
# window at half-voxel taps, one atomic add each, after 74 operations: the
# taps' weights by window slot 9, the x slots' centre-and-tap terms 7, the
# y and z taps' terms 6, the four centre rows 4 x 10, the four rows of the
# y and z taps alone 4 x 3.
_CORNER_WEIGHTS, _X_WEIGHTS, _SCATTER = 3 + 4, 8, 8 + 8
_EM_TAPS_SCATTER = 9 + 7 + 6 + 4 * 10 + 4 * 3 + 20
_BWD_STEP = 99
_BWD_PER_LIGHT = 145      # forward terms, per-light sums, d contrib, d reflection
_BWD_LIT = _STEP_OTF_TAPS + 12 + 1 + 3 + 5 + 6 + 2  # taps, normal, light_in
_BWD_PER_LIGHT_CHAIN = 26 + 1 + 3 * (54 + 2) + 10 + 30  # LUT derivatives, 3 angle adjoints, d n
_BWD_D_GRADIENT = 20      # the taps' cotangents from the normal's
# With lookup gradient volumes (K2L, K6L, the lookup gradient segment) the
# replay fetches K5's three gradient volumes instead of the six taps, and
# scatters emission's cotangent and the gradient's three components at the
# sample's corners: four scatters of 8 products and 8 atomic adds.
_BWD_LOOKUP = _STEP_LOOKUP_TAPS + 12 + 1 + 3 + 5 + 6 + 2


def bwd_flops_per_step(lit: bool, scatter: bool, ab_aliased: bool, re_aliased: bool,
                       n_lights: int, lookup: bool = False) -> int:
    ops = _BWD_STEP + (0 if ab_aliased else _BLEND)
    if lit:
        ops += ((0 if re_aliased else _BLEND) + (_BWD_LOOKUP if lookup else _BWD_LIT)
                + n_lights * _BWD_PER_LIGHT)
    if scatter:
        # the eight weights, for every volume scattered as one sample
        eight = not lit or lookup or not ab_aliased or not re_aliased
        ops += 7 + 1 + _CORNER_WEIGHTS + (_X_WEIGHTS if eight else 0)
        if lit:
            ops += _BWD_D_GRADIENT + (4 * _SCATTER if lookup else _EM_TAPS_SCATTER)
        else:
            ops += _SCATTER
        ops += 1 if ab_aliased else _SCATTER
        if lit:
            ops += n_lights * _BWD_PER_LIGHT_CHAIN + 1 + (1 if re_aliased else _SCATTER)
    return ops


# float32 operations of csrc/brick_common.cuh and brick_fwd.cu per composited
# sample: the walk (to_sample, owner, owner and opacity tests, t, tfar test,
# position) is 17, alpha 4, the opacity update 3, the shaded composite 16.
_BRICK_WALK = _COORDS + 4 + 2 + 1 + 1 + 3


def brick_flops_per_sample(form: str, ab_aliased: bool, re_aliased: bool = False,
                           lookup: bool = False, n_lights: int = 1) -> int:
    """form: transmittance (phase 1), segment (phase 2), scatter (the
    gradient segment), segment_lit or scatter_lit (the lit forms, with
    on-the-fly taps or, ``lookup``, gradient volumes: lit phase 2 and the
    lookup gradient segment)."""
    if form == "transmittance":
        return _BRICK_WALK + _FETCH + 4 + 3
    if form in ("segment", "segment_lit"):
        ops = _BRICK_WALK + _FETCH + (0 if ab_aliased else _BLEND) + 4 + 3 + 16
        if form == "segment_lit":  # K4's or K5's lit terms of a step
            ops += (0 if re_aliased else _BLEND) + _STEP_NORMAL + 3 + n_lights * _STEP_PER_LIGHT
            ops += _STEP_LOOKUP_TAPS if lookup else _STEP_OTF_TAPS
        return ops
    # the single-device backward step plus the owner (mul, floor, 2 clamps, test)
    lit = form == "scatter_lit"
    return bwd_flops_per_step(lit, True, ab_aliased, True if not lit else re_aliased,
                              n_lights if lit else 0, lookup=lit and lookup) + 5


def lookup_scatter_grids(scene, dims):
    """The grids that K6L and the lookup gradient segment scatter into at a
    sample's corners, by name, with ``dims(grid)`` (x, y, global z) of
    each: emission, the three gradient volumes, and absorption and
    reflection each unless aliased (an aliased role's cotangent is added to
    emission's before the scatter)."""
    keys = ["emission", "gradient_x", "gradient_y", "gradient_z"]
    keys += [k for k, aliased in (("absorption", scene.absorption_aliased),
                                  ("reflection", scene.reflection_aliased)) if not aliased]
    return {k: dims(getattr(scene, k).data) for k in keys}


# the grids whose cotangents go out together as one vector reduction a
# corner (csrc/lit_replay.cuh, scatter_packed): into an accumulator laid out
# as K5's pack where the pack exists, and beside it absorption's and
# reflection's into a float2 one where both lie as emission does
LOOKUP_PACK = ("emission", "gradient_x", "gradient_y", "gradient_z")
LOOKUP_PAIR = ("absorption", "reflection")


def lookup_scatter_packs(scene, place):
    """The groups of grids that K6L and the lookup gradient segment reduce
    into together, a vector a corner: the pack's four where emission and the
    gradient volumes have one shape (the kernels read the pack), else none
    (each volume scattered at its own corners); with the pack, absorption
    and reflection where neither is aliased and both have emission's shape
    and ``place(grid)`` (a brick's slab geometry: where the grid lies)."""
    def same(keys):
        return len({(tuple(getattr(scene, k).data.shape), place(getattr(scene, k).data))
                    for k in keys}) == 1

    if not same(LOOKUP_PACK):
        return ()
    pair = not (scene.absorption_aliased or scene.reflection_aliased)
    return (LOOKUP_PACK, LOOKUP_PAIR) if pair and same(("emission",) + LOOKUP_PAIR) else (
        LOOKUP_PACK,)


def corner_sectors(s, dims, elem):
    """Per sample, the distinct 32-byte sectors among the 8 clamped corners
    of normalized position ``s`` (x, y, z) in a grid of ``dims`` (x, y, z)
    and ``elem`` bytes a voxel (4: a float32 grid; 8: a float2
    accumulator; 16: a float4 one), x fastest: each distinct (y, z) row of
    the corners has sectors of its own (a row of the grids timed is a whole
    number of sectors, and a window's rows start on one), one where the x
    pair lies in one sector, else two."""
    import torch

    if dims[0] * elem % 32:
        raise ValueError(f"a row of {dims[0]} voxels of {elem} bytes is no whole number of "
                         "32-byte sectors")
    pairs = []
    for c, n in zip(s, dims):
        i = torch.clamp(torch.floor(c * float(n) - 0.5), -1.0, float(n))
        pairs.append((torch.clamp(i, 0, n - 1), torch.clamp(i + 1, 0, n - 1)))
    (x0, x1), (y0, y1), (z0, z1) = pairs
    per = 32 // elem  # voxels a sector
    return ((1 + (y0 != y1).long()) * (1 + (z0 != z1).long())
            * (1 + (torch.div(x0, per, rounding_mode="floor")
                    != torch.div(x1, per, rounding_mode="floor")).long()))


class ScatterAdds:
    """The atomic adds of a per-sample scatter without a carry into grids
    of ``dims`` ({name: (x, y, global z)}), as ``csrc/lit_replay.cuh``
    (scatter, scatter_packed) makes them: 8 values into each grid at every
    sample a ray composites, at its 8 clamped corners (two of them on one
    voxel where a corner is clamped), and the distinct voxels those adds
    reach. The grids of a group in ``packs`` (of one shape) go out together,
    one vector reduction of their values a corner (float4 for four, float2
    for two) into an accumulator of that layout; every other grid's as 8
    scalar ones. ``reductions`` counts them by width and ``sectors`` the
    32-byte sectors they reach a sample (corner_sectors), by target (a
    grid, or a group's names joined by "+"), beside those that 8 scalar
    adds into each grid would reach (``sectors_scalar``). ``visit`` takes
    each step's normalized positions and the rays that composite there;
    the tallies stay on the device until ``result``."""

    WIDTHS = {1: "scalar", 2: "float2", 4: "float4"}

    def __init__(self, dims, packs=()):
        self.dims = dims
        self.samples = None
        self.reached = {}  # the voxels reached, by grid dims
        packed = {k for group in packs for k in group}
        # target -> (dims, bytes a voxel, values a reduction)
        self.targets = {"+".join(group): (dims[group[0]], 4 * len(group), len(group))
                        for group in packs}
        self.targets.update({k: (d, 4, 1) for k, d in dims.items() if k not in packed})
        self.sectors = {}  # by (dims, bytes a voxel)

    def visit(self, s, act):
        import torch
        n = act.sum()
        self.samples = n if self.samples is None else self.samples + n
        for dims in set(self.dims.values()):
            reach = torch.ones(act.shape, dtype=torch.int64, device=act.device)
            for c, d in zip(s, dims):
                i = torch.clamp(torch.floor(c * float(d) - 0.5), -1.0, float(d))
                reach = reach * torch.where((i >= 0) & (i <= d - 2), 2, 1)
            reached = torch.where(act, reach, 0).sum()
            self.reached[dims] = reached + self.reached.get(dims, 0)
        scalar = {(d, 4) for d in self.dims.values()}
        for key in {t[:2] for t in self.targets.values()} | scalar:
            sectors = torch.where(act, corner_sectors(s, *key), 0).sum()
            self.sectors[key] = sectors + self.sectors.get(key, 0)

    def result(self):
        n = 0 if self.samples is None else int(self.samples)
        adds = {name: 8 * n for name in self.dims}
        voxels = {name: int(self.reached[d]) if n else 0 for name, d in self.dims.items()}
        reductions = dict.fromkeys(self.WIDTHS.values(), 0)
        for _, _, width in self.targets.values():
            reductions[self.WIDTHS[width]] += 8 * n
        sectors = {t: int(self.sectors[(d, e)]) if n else 0
                   for t, (d, e, _) in self.targets.items()}
        scalar = {name: int(self.sectors[(d, 4)]) if n else 0 for name, d in self.dims.items()}
        return {"samples": n, "adds": adds, "voxels": voxels, "reductions": reductions,
                "sectors": sectors, "sectors_scalar": scalar,
                "atomic_adds_per_sample": sum(adds.values()) / n if n else None,
                "voxels_per_sample": sum(voxels.values()) / n if n else None,
                "reductions_per_sample": {k: v / n if n else None
                                          for k, v in reductions.items()},
                "sectors_per_sample": sum(sectors.values()) / n if n else None,
                "sectors_per_sample_scalar": sum(scalar.values()) / n if n else None}


class CarryCount:
    """The atomic adds that the corner carry (``csrc/corner_carry.cuh``,
    ``CornerCarry``) makes into one carried grid of ``dims`` (x, y, global
    z) for ``n`` rays, when every sample's cotangent is nonzero; 8 a sample
    without the carry. ``visit`` takes each step's normalized positions and
    the rays that composite there: a ray's first sample flushes nothing, a
    later one in another cell the 8 corners minus those both cells share, and
    the ray's last cell its 8 corners (an upper bound: the kernel skips a
    flush of an exact zero). The same total is, exactly, the loads of a
    cache that keeps a ray's corner values in registers (corner_loads): 8 at
    a ray's first sample, then 8 minus the corners shared at each move, 8
    after a jump."""

    def __init__(self, n, dims, device):
        import torch
        self.dims = dims
        self.cell = torch.zeros((n, 3), dtype=torch.int64, device=device)
        self.seen = torch.zeros(n, dtype=torch.bool, device=device)
        self.flushes = torch.zeros(n, dtype=torch.int64, device=device)

    def visit(self, s, act):
        import torch
        new = torch.stack([torch.clamp(torch.floor(c * float(d) - 0.5), -1.0, float(d))
                           for c, d in zip(s, self.dims)], dim=-1).to(torch.int64)
        step = (new - self.cell).abs()
        shared = torch.where((step <= 1).all(dim=-1), (2 - step).prod(dim=-1), 0)
        self.flushes.add_(torch.where(act & self.seen, 8 - shared, 0))
        self.cell.copy_(torch.where(act[:, None], new, self.cell))
        self.seen.logical_or_(act)

    def total(self):
        return int(self.flushes.sum()) + 8 * int(self.seen.sum())


def carried_corners(brick, opts, w_in, entry, grid, visit=None):
    """``(samples, count)``: the samples of a brick's walk from the entry
    opacity ``w_in`` (None: from zero, as phase 1) and phase 1's ``entry``
    record (None: from step 0), and CarryCount's total over the cells of
    ``grid``, one of the brick's padded grids, counted from the plain walk's
    positions. ``visit(pos, act, consts)`` also sees every step's positions
    and the rays that composite there."""
    import torch
    from volume_renderer_tpu_torch.ops import brick_march
    from volume_renderer_tpu_torch.ops import raymarch_core as core

    with torch.no_grad():
        rays = brick_march.BrickRays(brick, opts, 0.0)
        consts = rays.consts
        dims = (grid.shape[2], grid.shape[1], brick.slab_geometry(grid)[1])  # x, y, global z
        sample_ab = brick_march.brick_samplers(brick).ab
        carry = CarryCount(rays.tnear.numel(), dims, grid.device)

        def composite(pos, act, sw):
            s = core.to_sample_coords(pos, consts)
            carry.visit(s, act)
            if visit is not None:
                visit(pos, act, consts)
            ab = sample_ab(s)
            return 1.0 - torch.exp(-(consts.factor_absorption * ab) * consts.tstep)

        steps = torch.zeros((rays.n_rows, opts.width), dtype=torch.int32, device=grid.device)
        rays.walk(w_in, composite, steps, entry)
        return int(steps.sum()), carry.total()


def corner_flushes(brick, opts, w_in, entry):
    """``(samples, flushes)``: the samples of a brick's gradient segment from
    the entry opacity ``w_in`` and phase 1's ``entry`` record, and the atomic
    adds into one carried grid that the kernel's corner carry makes for them
    (CarryCount), counted from the plain walk's positions. The cells are
    emission's; a grid of another shape is carried on cells of its own,
    which this does not count."""
    return carried_corners(brick, opts, w_in, entry, brick.scene.emission.data)


def tap_window_adds(s, sp, sm, dims):
    """Per ray, the atomic adds of the emission tap window's scatter
    (``csrc/lit_replay.cuh``, scatter_em_taps) for samples at normalized
    coordinates ``s`` whose plus and minus taps lie at ``sp`` and ``sm``
    along each axis (F3s of (R,) tensors), in a grid of ``dims`` (x, y,
    global z): a window voxel each (8 at the centre's slots 1, 2, a slot 0
    or 3 a row more along a near axis whose tap reaches it: 20 where every
    axis is near and the taps half a voxel out), and 16 for the two taps of
    a far axis on their own. An upper bound: the kernel skips a total that
    is exactly zero."""
    import torch

    def lower(c, n):
        return torch.clamp(torch.floor(c * float(n) - 0.5), -1.0, float(n))

    extra, far = [], 0
    for c, cp, cm, n in zip(s, sp, sm, dims):
        i = lower(c, n)
        dp, dm = lower(cp, n) - i, lower(cm, n) - i
        near = ((dp == 0) | (dp == 1)) & ((dm == 0) | (dm == -1))
        extra.append((near & (dm < 0)).long() + (near & (dp > 0)).long())
        far = far + (~near).long()
    return 4 * (2 + extra[0]) + 4 * extra[1] + 4 * extra[2] + 16 * far


def lit_carry_grids(scene) -> int:
    """The grids that a carry of the lit gradient segment's corner sums
    would take (measured on an H100 and dropped, PERF.md; csrc/brick_bwd.cu):
    absorption and reflection, each unless aliased, where every one of them
    has emission's shape (and so, in a brick or slab, its place); else
    none."""
    em = tuple(scene.emission.data.shape)
    own = [getattr(scene, k).data for k, aliased in (("absorption", scene.absorption_aliased),
                                                     ("reflection", scene.reflection_aliased))
           if not aliased]
    return len(own) if all(tuple(g.shape) == em for g in own) else 0


def lit_corner_flushes(brick, opts, w_in, entry):
    """corner_flushes for the lit gradient segment: from the plain walk's
    positions, its samples, the atomic adds of the emission tap window
    (tap_window_adds), 8 a sample for absorption and for reflection unless
    aliased (the kernel's atomic adds a sample), and what a carry of those
    two on the centre's cell would make instead (measured and dropped:
    CarryCount's flushes into one carried grid, on the lit_carry_grids)."""
    import torch
    from volume_renderer_tpu_torch.ops import raymarch_core as core

    em = brick.scene.emission.data
    dims = (em.shape[2], em.shape[1], brick.slab_geometry(em)[1])
    taps = [0]

    def visit(pos, act, consts):
        xp, xm, yp, ym, zp, zm = core.otf_tap_positions(pos, consts)
        adds = tap_window_adds(core.to_sample_coords(pos, consts), (xp.x, yp.y, zp.z),
                               (xm.x, ym.y, zm.z), dims)
        taps[0] += int(torch.where(act, adds, 0).sum())

    samples, flushes = carried_corners(brick, opts, w_in, entry, em, visit)
    carry = lit_carry_grids(brick.scene)
    roles = 2 - brick.scene.absorption_aliased - brick.scene.reflection_aliased
    return {"samples": samples, "tap_adds": taps[0], "flushes_per_grid": flushes,
            "carry_grids": carry,
            "atomic_adds_per_sample": (taps[0] + 8 * roles * samples) / samples,
            "atomic_adds_per_sample_carried": (taps[0] + carry * flushes
                                               + 8 * (roles - carry) * samples) / samples}


def lookup_scatter_adds(brick, opts, w_in, entry):
    """ScatterAdds of the lookup gradient segment (``csrc/brick_bwd.cu``,
    brick_lookup bwd kernels) on one brick, counted from the plain walk's
    positions (carried_corners), the grids' z placed as the brick's."""
    from volume_renderer_tpu_torch.ops import raymarch_core as core

    def dims(v):
        return v.shape[2], v.shape[1], brick.slab_geometry(v)[1]

    count = ScatterAdds(lookup_scatter_grids(brick.scene, dims),
                        lookup_scatter_packs(brick.scene, brick.slab_geometry))
    samples, _ = carried_corners(brick, opts, w_in, entry, brick.scene.emission.data,
                                 lambda pos, act, consts: count.visit(
                                     core.to_sample_coords(pos, consts), act))
    out = count.result()
    if out["samples"] != samples:
        raise RuntimeError(f"the walk visited {out['samples']} samples of {samples}")
    return out


def tail_factor(steps, cols=16, rows=16):
    """A launch's tail factor in blocks of ``cols`` x ``rows`` threads, from
    its steps plane (H, W) (each ray's samples) or a list of them (a form's
    launches over the bricks, summed): the sum over the blocks of their
    threads times their largest count, over the sum of the counts. A block
    keeps its threads until its longest ray ends, so this is the thread
    time a launch holds per thread time of work; 1 where every ray of a
    block takes as many samples. A block's threads are its pixels inside
    the image; warps are 16 x 2 blocks of 16-wide ones. None without a
    sample."""
    import torch
    import torch.nn.functional as F

    held = work = 0
    for plane in steps if isinstance(steps, (list, tuple)) else [steps]:
        h, w = plane.shape
        pad = (0, -w % cols, 0, -h % rows)
        counts = F.pad(plane.to(torch.int64), pad)
        inside = F.pad(torch.ones_like(plane, dtype=torch.int64), pad)
        hb, wb = counts.shape[0] // rows, counts.shape[1] // cols
        most = counts.reshape(hb, rows, wb, cols).amax(dim=(1, 3))
        threads = inside.reshape(hb, rows, wb, cols).sum(dim=(1, 3))
        held += int((threads * most).sum())
        work += int(plane.to(torch.int64).sum())
    return held / work if work else None


# the block shapes the tails are taken for: phase 2's and K4's and K5's
# blocks, the smaller ones tried for lit phase 2, and a warp
TAIL_SHAPES = ((16, 16), (16, 8), (16, 4), (16, 2))


def tail_factors(steps):
    """tail_factor for each of TAIL_SHAPES, keyed "<cols>x<rows>"."""
    return {f"{c}x{r}": tail_factor(steps, c, r) for c, r in TAIL_SHAPES}


def corner_loads(brick, opts, w_in, entry):
    """``(samples, loads)``: the samples of a brick's walk from the entry
    opacity ``w_in`` (None for phase 1, which starts from zero) and the
    ``entry`` record (None: from step 0), and the corner loads that a cache
    of each ray's 8 corner values in registers would make for them (the
    gather side of the corner carry; tried for phase 1 and dropped,
    PERF.md), counted from the plain walk's positions: 8 at a ray's first
    sample and after a jump, else the corners a move brings in, with no
    skip. 8 a sample without the cache. The cells are those of the one
    volume phase 1 fetches: absorption, or emission where absorption is
    aliased."""
    return carried_corners(brick, opts, w_in, entry, brick.scene.absorption_volume.data)


def march_samples(scene, opts, y0=0, rows=None):
    """The plain march of ``rows`` image rows from ``y0``: its constants, each
    ray's first position and step (flat, r = y * W + x), and its number of
    samples; sample k of a ray lies at its first position plus k
    accumulated steps."""
    import torch
    from volume_renderer_tpu_torch.ops.forward import _init_rays, render_rows

    rows = opts.height if rows is None else rows
    steps = torch.zeros((rows, opts.width), dtype=torch.int32, device=scene.device)
    render_rows(scene, opts, 0.0, y0, rows, steps=steps)
    consts, _, pos, step, _, _, _ = _init_rays(scene, opts, 0.0, y0, rows)
    return consts, pos, step, steps.reshape(-1)


def march_flushes(scene, opts):
    """``(samples, {grid: flushes})``: the samples of K3 (``csrc/march_bwd.cu``,
    march_bwd_scatter_kernel) on the whole image and the atomic adds of its
    corner carry into each gradient grid (CarryCount), counted from the
    plain march's positions. Absorption of emission's shape shares its cells;
    one of another shape is carried on cells of its own."""
    import torch
    from volume_renderer_tpu_torch.ops import raymarch_core as core

    with torch.no_grad():
        consts, pos, step, steps = march_samples(scene, opts)

        def dims(v):
            return (v.shape[2], v.shape[1], v.shape[0])

        em = scene.emission.data
        carries = {"emission": CarryCount(steps.numel(), dims(em), em.device)}
        if not scene.absorption_aliased:
            ab = scene.absorption.data
            carries["absorption"] = (carries["emission"] if ab.shape == em.shape
                                     else CarryCount(steps.numel(), dims(ab), em.device))
        distinct = list({id(c): c for c in carries.values()}.values())
        for k in range(int(steps.max())):
            s = core.to_sample_coords(pos, consts)
            for carry in distinct:
                carry.visit(s, steps > k)
            pos = pos + step
        return int(steps.sum()), {grid: carry.total() for grid, carry in carries.items()}


def march_scatter_adds(scene, opts, steps=None):
    """ScatterAdds of K6L (``csrc/march_bwd.cu``, march_bwd_lookup_scatter
    kernels) on the whole image of a lit lookup scene, counted from the
    plain march's positions over each ray's samples: the plain march's
    count, or ``steps``, the (H, W) samples plane of K5's launch on the
    scene, whose samples K6L replays."""
    import torch
    from volume_renderer_tpu_torch.ops import raymarch_core as core
    from volume_renderer_tpu_torch.ops.forward import _init_rays

    with torch.no_grad():
        if steps is None:
            consts, pos, step, steps = march_samples(scene, opts)
        else:
            consts, _, pos, step, _, _, _ = _init_rays(scene, opts, 0.0, 0, opts.height)
            steps = steps.reshape(-1)
        def dims(v):
            return v.shape[2], v.shape[1], v.shape[0]

        count = ScatterAdds(lookup_scatter_grids(scene, dims), lookup_scatter_packs(scene, dims))
        for k in range(int(steps.max())):
            count.visit(core.to_sample_coords(pos, consts), steps > k)
            pos = pos + step
        out = count.result()
        if out["samples"] != int(steps.sum()):
            raise RuntimeError(f"the walk visited {out['samples']} samples of {int(steps.sum())}")
        return out


# A 128-byte line of the tiled layout that K1's gather model compares: 4 x 4 x 2 voxels.
TILE = (4, 4, 2)


def sector_counts(ix, iy, iz, act, dims, tile=TILE, by=None, elem=4):
    """The 32-byte sectors and 128-byte lines of a volume of ``dims`` (x, y,
    z) and ``elem`` bytes a voxel (4: float32; 16: four float32 volumes
    packed, one float4 a voxel) that warp load instructions touch: ``ix``,
    ``iy``, ``iz`` (..., 32) are each lane's voxel, ``act`` (..., 32)
    whether the lane loads. Summed over the instructions, for the x-linear
    layout (x fastest, as the volumes are) and for a tiled one (``tile``
    voxels together, x fastest inside, the tiles in x-fastest order; 4x4x2
    float32 is one line). Returns {layout: (sectors, lines)}; with ``by``, a
    tensor (n, 4) of the linear sectors and lines, then the tiled ones, for
    each index n of dimension ``by`` of the inputs."""
    import torch

    w, h, _ = dims
    tx, ty, tz = tile
    linear = (ix + w * (iy + h * iz)) * elem
    tiles = ix // tx + (-(-w // tx)) * (iy // ty + (-(-h // ty)) * (iz // tz))
    tiled = (tiles * (tx * ty * tz) + ix % tx + tx * (iy % ty + ty * (iz % tz))) * elem
    ids = torch.stack([linear // 32, linear // 128, tiled // 32, tiled // 128])
    ids = torch.where(act, ids, -1).sort(dim=-1).values
    distinct = (ids[..., 1:] != ids[..., :-1]).sum(-1) + 1 - (ids[..., 0] == -1).long()
    if by is not None:  # dimension by of the inputs is dimension by + 1 of distinct
        return distinct.movedim(by + 1, 1).reshape(4, distinct.shape[by + 1], -1).sum(-1).T
    sums = [int(v) for v in distinct.reshape(4, -1).sum(-1)]
    return {"linear": (sums[0], sums[1]), "tiled": (sums[2], sums[3])}


def warp_lanes(width, rows, warp_cols):
    """(warps, 32) the flat band pixel (r = y * width + x) of each lane of
    the warps of 16x16 blocks whose warps cover warp_cols x 32 / warp_cols
    pixels, the warps of a block side by side, then row by row. 16 columns
    is threadIdx order, K1's (csrc/march_fwd.cu)."""
    import torch

    assert width % 16 == 0 and rows % 16 == 0 and 16 % warp_cols == 0
    t = torch.arange(256)
    lane, warp = t % 32, t // 32
    across = 16 // warp_cols
    lx = (warp % across) * warp_cols + lane % warp_cols
    ly = (warp // across) * (32 // warp_cols) + lane // warp_cols
    bx = torch.arange(width // 16)[None, :, None] * 16
    by = torch.arange(rows // 16)[:, None, None] * 16
    return ((by + ly) * width + bx + lx).reshape(-1, 32)


def gather_footprint(scene, opts, y0, rows, warp_cols=(16, 8, 4), elems=(4,)):
    """The gather model of the forward kernels on ``rows`` image rows from
    ``y0``: from the plain march's positions, for each warp shape, element
    size and layout (sector_counts), the sectors and lines that the 8 corner
    loads of a grid of emission's shape touch, by warp load instruction and
    by sample. An element of 4 bytes is one float32 volume (K1's loads), of
    16 the K5 pack (emission and the three gradient volumes, one float4 a
    corner); keyed "warp_<cols>x<rows>", then "_<elem>B" for elements other
    than 4 bytes."""
    import torch
    from volume_renderer_tpu_torch.ops import raymarch_core as core

    with torch.no_grad():
        consts, pos, step, steps = march_samples(scene, opts, y0, rows)
        d, h, w = scene.emission.data.shape
        dev = steps.device
        # every warp shape's lanes, one after the other: one count a step
        idx = torch.stack([warp_lanes(opts.width, rows, c) for c in warp_cols]).to(dev)
        counts = torch.zeros((len(elems), len(warp_cols), 5), dtype=torch.int64, device=dev)
        for k in range(int(steps.max())):
            s = core.to_sample_coords(pos, consts)
            lo = [torch.clamp(torch.floor(c * float(n) - 0.5), -1.0, float(n)).to(torch.int64)
                  for c, n in zip(s, (w, h, d))]
            corners = [[torch.clamp(i + j, 0, n - 1) for j in (0, 1)] for i, n in zip(lo, (w, h, d))]
            # corner a + 2 b + 4 c: (x + a, y + b, z + c), by shape, warp and lane
            xyz = [torch.stack([corners[axis][(k8 >> axis) & 1] for k8 in range(8)])[:, idx]
                   for axis in range(3)]
            act = (steps > k)[idx]
            for e, elem in enumerate(elems):
                counts[e, :, :4] += sector_counts(*xyz, act[None].expand(8, -1, -1, -1),
                                                  (w, h, d), by=1, elem=elem)
            counts[:, :, 4] += 8 * act.any(-1).sum(-1)
            pos = pos + step
        samples = int(steps.sum())
        out = {"rows": [y0, rows], "samples": samples, "tile": list(TILE)}
        for elem, by_shape in zip(elems, counts.cpu()):
            for c, row in zip(warp_cols, by_shape):
                n = int(row[4])
                t = {"linear": [int(v) for v in row[:2]], "tiled": [int(v) for v in row[2:4]]}
                suffix = "" if elem == 4 else f"_{elem}B"
                out[f"warp_{c}x{32 // c}{suffix}"] = {
                    "instructions": n,
                    **{layout: {"sectors": t[layout][0], "lines": t[layout][1],
                                "sectors_per_instruction": t[layout][0] / n,
                                "lines_per_instruction": t[layout][1] / n,
                                "sectors_per_sample": t[layout][0] / samples,
                                "lines_per_sample": t[layout][1] / samples}
                       for layout in ("linear", "tiled")}}
        return out


# Template parameters of each kernel of csrc/, in order, and the mode that a
# set of their values makes.
KERNEL_PARAMS = {
    "march_kernel": ("LIT", "LOOKUP", "AB_ALIASED", "RE_ALIASED", "PACKED"),
    "march_bwd_params_kernel": ("AB_ALIASED", "PAIRED"),
    "march_bwd_lit_params_kernel": ("AB_ALIASED", "RE_ALIASED"),
    "march_bwd_scatter_kernel": ("AB_ALIASED", "AB_OWN_CELL"),
    "march_bwd_lit_scatter_kernel": ("AB_ALIASED", "RE_ALIASED"),
    "brick_fwd_kernel": ("SHADE", "AB_ALIASED"),
    "brick_lit_fwd_kernel": ("LOOKUP", "AB_ALIASED", "RE_ALIASED", "PACKED"),
    "brick_bwd_kernel": ("AB_ALIASED", "AB_OWN_CELL"),
    "brick_lit_bwd_kernel": ("AB_ALIASED", "RE_ALIASED"),
    "march_bwd_lookup_params_kernel": ("AB_ALIASED", "RE_ALIASED", "PAIR_IN"),
    "march_bwd_lookup_scatter_kernel": ("AB_ALIASED", "RE_ALIASED", "PAIRED"),
    "march_bwd_lookup_unpacked_params_kernel": ("AB_ALIASED", "RE_ALIASED"),
    "march_bwd_lookup_unpacked_scatter_kernel": ("AB_ALIASED", "RE_ALIASED"),
    "brick_lookup_bwd_kernel": ("AB_ALIASED", "RE_ALIASED", "PAIRED"),
    "brick_lookup_unpacked_bwd_kernel": ("AB_ALIASED", "RE_ALIASED"),
}
# Threads a block by mode or kernel, where it is not 16x16 (K3, K6, K6L and
# the K7 gradient segments run in 16x8 blocks: csrc/march_bwd.cu,
# csrc/brick_bwd.cu; K7 phase 1, lit phase 2, K2 and K2L in 16 rows of a
# constant of their source: kernel_threads)
KERNEL_THREADS = {"K3": 128, "K6": 128, "K6L": 128, "K7_scatter": 128, "K7_scatter_lit": 128,
                  "K7_scatter_lookup": 128}
# the constants of 16 x ROWS blocks: kernel or mode -> (source, constant)
BLOCK_ROWS = {"K7_transmittance": ("brick_fwd.cu", "kPhase1Rows"),
              "K7_segment_lit": ("brick_fwd.cu", "kLitRows"),
              "K7_segment_lit_lookup": ("brick_fwd.cu", "kLitLookupRows"),
              "march_bwd_params_kernel": ("march_bwd.cu", "kK2Rows"),
              "march_bwd_lit_params_kernel": ("march_bwd.cu", "kK2LitRows"),
              "march_bwd_lookup_params_kernel": ("march_bwd.cu", "kK2LRows"),
              "march_bwd_lookup_unpacked_params_kernel": ("march_bwd.cu", "kK2LRows")}


def kernel_threads(repo):
    """KERNEL_THREADS with the blocks of K7 phase 1, lit phase 2, K2 and K2L
    as the sources under ``repo`` set them (16x16 where a source has no such
    constant)."""
    out = dict(KERNEL_THREADS)
    for key, (source, name) in BLOCK_ROWS.items():
        with open(os.path.join(repo, "volume_renderer_tpu_torch", "csrc", source)) as f:
            m = re.search(r"constexpr int %s = (\d+);" % name, f.read())
        out[key] = 16 * int(m.group(1)) if m else 256
    return out
# 4 bricks, all on the one card; the rows of phase 8's plain passes
BRICKS, BRICK_BAND = 4, 96
# phase 8's lit scenes: the plain lit passes' time follows the march's steps
LIT_BRICKS = dict(volume=32, width=96, height=64, band=32)


def kernel_mode_of(kernel: str, args) -> str:
    if kernel == "march_kernel":
        return "K1" if not args[0] else ("K5" if args[1] else "K4")
    if kernel in ("march_bwd_params_kernel", "march_bwd_lit_params_kernel"):
        return "K2"
    if kernel in ("march_bwd_lookup_params_kernel", "march_bwd_lookup_unpacked_params_kernel"):
        return "K2L"
    if kernel in ("march_bwd_lookup_scatter_kernel", "march_bwd_lookup_unpacked_scatter_kernel"):
        return "K6L"
    if kernel in ("brick_lookup_bwd_kernel", "brick_lookup_unpacked_bwd_kernel"):
        return "K7_scatter_lookup"
    if kernel == "march_bwd_scatter_kernel":
        return "K3"
    if kernel == "march_bwd_lit_scatter_kernel":
        return "K6"
    if kernel == "brick_fwd_kernel":
        return "K7_segment" if args[0] else "K7_transmittance"
    if kernel == "brick_lit_fwd_kernel":  # lookup has blocks of its own
        return "K7_segment_lit_lookup" if args[0] else "K7_segment_lit"
    if kernel == "brick_lit_bwd_kernel":
        return "K7_scatter_lit"
    return "K7_scatter"


def blocks_per_sm(registers: int, threads: int) -> int:
    """Blocks of ``threads`` that the registers of an H100 SM hold: 65,536
    of them, allocated to a warp in units of 256, at most 64 warps and 32
    blocks an SM."""
    per_warp = -(-registers * 32 // 256) * 256
    return min(min(65536 // per_warp, 64) // (threads // 32), 32)


def ptxas_by_kernel(log: str, strict: bool = True, threads=KERNEL_THREADS) -> dict:
    """What ``nvcc -Xptxas -v`` reports for each kernel instantiation, keyed
    "<mode> <kernel><template arguments>", e.g. "K2 march_bwd_params_kernel<0,1>".
    With ``strict`` a kernel must have the template arguments that
    KERNEL_PARAMS lists. Without it (another version of the sources) a
    kernel whose arguments differ is reported without its blocks an SM,
    since its block shape is not known here. ``threads``: a block's threads
    by mode or kernel, where not 256."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(%s)I((?:Lb[01]E)+)E" % "|".join(KERNEL_PARAMS),
                      line)
        if m:
            args = [int(b) for b in re.findall(r"Lb([01])E", m.group(2))]
            known = len(args) == len(KERNEL_PARAMS[m.group(1)])
            assert known or not strict, line
            mode = kernel_mode_of(m.group(1), args)
            key = f"{mode} {m.group(1)}<{','.join(map(str, args))}>"
            n = threads.get(m.group(1), threads.get(mode, 256))
            out[key] = {"threads": n if known else None}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and key:
            out[key].update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                            spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and key:
            out[key]["registers"] = int(m.group(1))
            if out[key]["threads"]:
                blocks = blocks_per_sm(int(m.group(1)), out[key]["threads"])
                out[key].update(blocks_per_sm=blocks,
                                warps_per_sm=blocks * out[key]["threads"] // 32)
    return out


# ---- phases 16-18: camera gradients, the oracle, utils ------------------
# All plain PyTorch on the card but the forward kernels the oracle is held
# against. Each phase takes the helpers of main() as ``ctx``.
# The plain march and replay cost hundreds to thousands of launches a step
# whatever the rays, so their time follows the steps, that is the volume's
# edge: at full size only the K1 oracle band runs. The camera checks, unlit
# and lit, run at 32^3 / 256^2, the lit oracle bands at 64^3 / 256^2, the
# pose fit at 12^3 / 24^2 (at 64^3 / 96^2 its 12 steps take a minute).
CAMERA = dict(volume=32, image=256, first_row=112, rows=32)
POSE_FIT = dict(volume=12, image=24, steps=12, lr=5e-3)
ORACLE = dict(first_row=224, rows=64, lit_volume=64, lit_image=256, lit_first_row=112,
              lit_rows=32, facade_volume=32, facade_image=(64, 16))
BENCH_ORACLE = dict(volume=32, image=24, atol=3e-5, rtol=3e-4)   # bench.py's check
# The JAX package's bounds for its fused camera gradients against its scan
# (tests/test_camera_grad.py): the rotation's largest error over its largest
# magnitude, each intrinsic's error over the larger of the two values.
CAMERA_TOL = {"camera_rotation": 5e-3, "camera_focal": 2e-3, "camera_distance": 2e-3,
              "camera_x_offset": 2e-3}


def camera_grads_phase(ctx) -> dict:
    """render_fused(camera_grads=True) on a band against autograd of the
    fixed-trip march (render_rows(differentiable=True)) on the same band, at
    32^3 on the noisy unlit scene and on the lit OTF one; then
    a pose-and-intrinsics fit through it."""
    import torch

    from volume_renderer_tpu_torch.ops.cuda_march import render_rows_fast
    from volume_renderer_tpu_torch.ops.forward import render_rows
    from volume_renderer_tpu_torch.ops.vjp import (CAMERA_KEYS, POSE_KEYS, merge_scene,
                                                   render_fused, split_scene)

    t_phase = time.perf_counter()
    dev = ctx.dev

    def posed(scene, x_offset=0.05):
        """The scene with its camera as fresh leaves, and the leaves, the x
        offset among them."""
        diff, template = split_scene(scene, with_camera=True)
        leaves = {k: diff[k].detach().clone().requires_grad_(True) for k in CAMERA_KEYS}
        leaves["camera_x_offset"] = torch.tensor(x_offset, device=dev, requires_grad=True)
        return merge_scene(template, {**diff, **leaves}), leaves

    def versus_scan(name, scene, image, first_row, rows, seed):
        opts = scene.options(image, image)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        g = torch.randn((rows, image, 3), generator=gen, device=dev) * 1e-3
        s, fused = posed(scene)
        img, fwd_ms = ctx.timed(lambda: render_fused(s, opts, fused["camera_x_offset"],
                                                     first_row, rows, camera_grads=True))
        _, bwd_ms = ctx.timed(lambda: img.backward(g))
        # The scan's fixed trip count cut to the band's longest march (the
        # kernel's sample counts, its plain version's): the steps after it
        # composite nothing and carry no gradient, so the result is the same.
        counts = torch.zeros((rows, image), dtype=torch.int32, device=dev)
        render_rows_fast(scene, opts, 0.05, first_row, rows, steps=counts)
        scan_opts = type(opts)(opts.width, opts.height, opts.boxmin, opts.boxmax, opts.tstep,
                               opts.gradient_step, int(counts.max()) + 1)
        s, scan = posed(scene)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def scan_grads():
            out = render_rows(s, scan_opts, scan["camera_x_offset"], first_row, rows,
                              differentiable=True)
            out.backward(g)
            return out.detach()

        scan_img, scan_ms = ctx.timed(scan_grads)
        scan_peak = torch.cuda.max_memory_allocated() - base
        if not torch.equal(img.detach(), scan_img):
            raise RuntimeError(f"camera_grads {name}: the fused and the scan images differ")
        errs, grads = {}, {}
        for key in POSE_KEYS:
            got, want = fused[key].grad, scan[key].grad
            if not (bool(torch.isfinite(got).all()) and bool(want.abs().max() > 0)):
                raise RuntimeError(f"camera_grads {name} {key}: {got} against {want}")
            if key == "camera_rotation":
                err = float((got - want).abs().max() / want.abs().max())
            else:
                err = float((got - want).abs() / torch.maximum(got.abs(), want.abs()))
            if not err <= CAMERA_TOL[key]:
                raise RuntimeError(f"camera_grads {name} {key}: {err:.3e} off the scan "
                                   f"(bound {CAMERA_TOL[key]})")
            errs[key], grads[key] = err, got.tolist()
        return {"volume": scene.emission.data.shape[0], "image": image,
                "band_first_row": first_row, "band_rows": rows, "n_steps": opts.n_steps,
                "scan_steps": scan_opts.n_steps,
                "fused_forward_ms": fwd_ms, "fused_backward_ms": bwd_ms,
                "scan_forward_backward_ms": scan_ms, "scan_peak_mib": scan_peak / 2 ** 20,
                "err": errs, "grads": grads}

    out = {"tolerance": CAMERA_TOL, "reference": "render_rows(differentiable=True) autograd"}
    t0 = time.perf_counter()
    out["unlit"] = versus_scan("unlit", ctx.flagship(CAMERA["volume"], "K1", ab_aliased=False,
                                                     noise=0.05),
                               CAMERA["image"], CAMERA["first_row"], CAMERA["rows"], 11)
    out["unlit"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["lit_otf"] = versus_scan("lit OTF", ctx.flagship(CAMERA["volume"], "K4",
                                                         ab_aliased=False, noise=0.05),
                                 CAMERA["image"], CAMERA["first_row"],
                                 CAMERA["rows"], 12)
    out["lit_otf"]["seconds"] = time.perf_counter() - t0

    # the pose fit: rotation, focal length and distance perturbed, Adam back
    t0 = time.perf_counter()
    n, image = POSE_FIT["volume"], POSE_FIT["image"]
    scene = ctx.flagship(n, "K1", ab_aliased=False, noise=0.05)
    opts = scene.options(image, image)
    target = render_fused(scene, opts).detach()
    diff0, template = split_scene(scene, with_camera=True)
    truth = {k: diff0[k].detach().clone() for k in CAMERA_KEYS}
    params = {"camera_rotation": (truth["camera_rotation"] + 0.02).requires_grad_(True),
              "camera_focal": (truth["camera_focal"] + 0.15).requires_grad_(True),
              "camera_distance": (truth["camera_distance"] - 0.2).requires_grad_(True)}
    optimizer = torch.optim.Adam(list(params.values()), lr=POSE_FIT["lr"])

    def pose_err():
        return sum(float(torch.sum((params[k].detach() - truth[k]) ** 2)) for k in truth)

    errors, losses = [pose_err()], []
    for _ in range(POSE_FIT["steps"]):
        optimizer.zero_grad()
        img = render_fused(merge_scene(template, {**diff0, **params}), opts, camera_grads=True)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        optimizer.step()
        losses.append(float(loss.detach()))
        errors.append(pose_err())
    with torch.no_grad():
        losses.append(float(torch.mean((render_fused(merge_scene(template, {**diff0, **params}),
                                                     opts) - target) ** 2)))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0] and errors[-1] < errors[0]):
        raise RuntimeError(f"the pose fit did not descend: losses {losses}, errors {errors}")
    out["pose_fit"] = {"volume": n, "image": image, "steps": POSE_FIT["steps"], "optimizer": "Adam",
                       "lr": POSE_FIT["lr"], "losses": losses, "pose_sq_errors": errors,
                       "step_ms": (time.perf_counter() - t0) * 1e3 / POSE_FIT["steps"],
                       "seconds": time.perf_counter() - t0}
    out["seconds"] = time.perf_counter() - t_phase
    return out


def oracle_phase(ctx) -> dict:
    """render_oracle on a band against K1, K4 and K5 on the same rows; the
    facade's oracle backend against its forward one; bench.py's check."""
    import torch

    from volume_renderer_tpu_torch import LightSource, Volume, VolumeRenderer, henyey_greenstein_lut
    from volume_renderer_tpu_torch.ops import cuda_march
    from volume_renderer_tpu_torch.ops.cuda_march import render_forward_fast
    from volume_renderer_tpu_torch.ops.oracle import render_oracle

    t_phase = time.perf_counter()
    modes = ("K1", "K4", "K5")
    # (volume, image, first row, rows) of each mode's band
    cells = {mode: (ctx.MAIN["volume"], ctx.MAIN["image"], ORACLE["first_row"], ORACLE["rows"])
             if mode == "K1" else (ORACLE["lit_volume"], ORACLE["lit_image"],
                                   ORACLE["lit_first_row"], ORACLE["lit_rows"])
             for mode in modes}
    scenes = {mode: ctx.flagship(cells[mode][0], mode) for mode in modes}
    opts = {mode: scenes[mode].options(cells[mode][1], cells[mode][1]) for mode in modes}

    def counted(fn):
        torch.cuda.synchronize()
        cuda_march.reset_launch_counts()
        result = fn()
        torch.cuda.synchronize()
        return result, dict(cuda_march.LAUNCHES_BY_MODE)

    kernel_images, kernel_launches = counted(
        lambda: {mode: render_forward_fast(scenes[mode], opts[mode]) for mode in modes})
    out = {"tolerance": {"atol": BENCH_ORACLE["atol"], "rtol": BENCH_ORACLE["rtol"]},
           "kernel_launches": kernel_launches}
    oracle_launches = None
    for mode in modes:
        n, size, y0, rows = cells[mode]
        (img, ms), counts = counted(lambda: ctx.timed(lambda: render_oracle(
            scenes[mode], opts[mode], y_offset=y0, n_rows=rows)))
        oracle_launches = {k: (oracle_launches or {}).get(k, 0) + v for k, v in counts.items()}
        kernel_rows = kernel_images[mode][y0:y0 + rows]
        out[mode] = {"volume": n, "image": size, "band_first_row": y0, "band_rows": rows,
                     "oracle_band_ms": ms, "max_abs_err": ctx.check(
                         f"oracle {mode}", kernel_rows, img, BENCH_ORACLE["atol"],
                         BENCH_ORACLE["rtol"], None)}
    out["oracle_launches"] = oracle_launches
    for mode in modes:
        if kernel_launches[mode] != 1:
            raise RuntimeError(f"the forward side launched {kernel_launches}")
    if any(oracle_launches.values()):
        raise RuntimeError(f"the oracle launched a kernel: {oracle_launches}")

    # the facade, backend="oracle" against backend="forward", on the main
    # path's scenes cut to 32^3 and a 64 x 16 image (at 256^3 and 512 x 64
    # the oracle takes 3 to 19 s a mode)
    em = ctx.shell(ORACLE["facade_volume"]).cpu().numpy()
    width, height = ORACLE["facade_image"]
    facade = {}
    for mode in modes:
        images = {}
        for backend in ("forward", "oracle"):
            r = VolumeRenderer(backend=backend)
            r.volume_emission = Volume.create(em)
            r.volume_absorption = Volume.create(em)
            r.factor_absorption, r.factor_reflection, r.color = 0.6, 0.4, (1.0, 0.9, 0.8)
            r.focal_length, r.distance_to_object = 3.0, 6.0
            r.rotate(125, 25, 0)
            r.image_resolution = (width, height)
            if mode != "K1":
                r.volume_reflection = Volume.create(em)
                r.volume_illumination = henyey_greenstein_lut(32)
                r.light_sources = [LightSource([2.0, 3.0, -1.5], [1.0, 1.0, 1.0])]
            if mode == "K5":
                r.volume_gradient_x, r.volume_gradient_y, r.volume_gradient_z = (
                    Volume.create(em).gradient_volumes())
            (images[backend], ms), counts = counted(lambda: ctx.timed(r.render))
            facade.setdefault(mode, {})[f"{backend}_ms"] = ms
            facade[mode][f"{backend}_launches"] = counts[mode]
        if facade[mode]["forward_launches"] != 1 or facade[mode]["oracle_launches"] != 0:
            raise RuntimeError(f"facade launches {mode}: {facade[mode]}")
        facade[mode]["max_abs_err"] = ctx.check(f"facade oracle {mode}", images["forward"],
                                                images["oracle"], BENCH_ORACLE["atol"],
                                                BENCH_ORACLE["rtol"], None)
    out["facade"] = {"volume": ORACLE["facade_volume"], "image": [width, height], **facade}

    # bench.py's oracle_allclose: the 32^3 unlit flagship at 24^2
    scene = ctx.flagship(BENCH_ORACLE["volume"], "K1", ab_aliased=False)
    bopts = scene.options(BENCH_ORACLE["image"], BENCH_ORACLE["image"])
    got, want = render_forward_fast(scene, bopts), render_oracle(scene, bopts)
    out["bench_check"] = {**BENCH_ORACLE, "max_abs_err": ctx.check(
        "bench oracle", got, want, BENCH_ORACLE["atol"], BENCH_ORACLE["rtol"], None),
        "allclose": True}
    out["seconds"] = time.perf_counter() - t_phase
    return out


def utils_phase(ctx, trace_dir: str, checkpoint_dir: str) -> dict:
    """utils.trace around one K1 render (the trace must name march_kernel),
    Stopwatch and PhaseTimer around the same render beside CUDA events, and
    a checkpoint round trip of train_step_fast's params and Adam state."""
    import shutil

    import torch

    from volume_renderer_tpu_torch import train
    from volume_renderer_tpu_torch.ops.cuda_march import render_forward_fast
    from volume_renderer_tpu_torch.utils import (PhaseTimer, Stopwatch, load_checkpoint,
                                                 save_checkpoint, trace)

    t_phase = time.perf_counter()
    n, size = ctx.MAIN["volume"], ctx.MAIN["image"]
    scene = ctx.flagship(n, "K1")
    opts = scene.options(size, size)

    def render():
        return render_forward_fast(scene, opts)

    event_ms, event_times = ctx.median_ms(render)
    host_ms = ctx.host_ms(render)
    # the trace: one warm render inside it
    logdir = trace_dir
    shutil.rmtree(logdir, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with trace(logdir) as prof:
        _, traced_ms = ctx.timed(render)
    traced_host_ms = (time.perf_counter() - t0) * 1e3
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    marches = [e for e in kernels if "march_kernel" in e.get("name", "")]
    if not marches:
        raise RuntimeError(f"the trace names no march_kernel: {sorted({e.get('name') for e in kernels})[:20]}")
    device_ms = {a.key: a.device_time_total / 1e3 for a in prof.key_averages()
                 if "march_kernel" in a.key}
    # Stopwatch and PhaseTimer on the host's clock, waiting for the card
    sw, pt = Stopwatch("utils"), PhaseTimer()
    sw_ms, pt_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        sw.start("render")
        img = render()
        sw_ms.append(sw.stop("render", sync=img) * 1e3)
        torch.cuda.synchronize()
        before = pt.totals.get("render", 0.0)
        pt.timed("render", render)
        pt_ms.append((pt.totals["render"] - before) * 1e3)

    # the checkpoint: three train_step_fast steps, save, the fourth step's
    # loss with and without a reload
    t0 = time.perf_counter()
    cn = ctx.COMPARE["volume"]
    cscene = ctx.flagship(cn, "K1", ab_aliased=False, noise=0.05)
    copts = cscene.options(ctx.COMPARE["width"], ctx.COMPARE["height"])
    target = render_forward_fast(cscene, copts)

    def start():
        params, static = train.split_params(cscene)
        with torch.no_grad():
            params["emission"].mul_(1.3).add_(0.05)
        return params, static, torch.optim.Adam(list(params.values()), lr=2e-3)

    params, static, optimizer = start()
    losses = [float(train.train_step_fast(params, optimizer, static, copts, target))
              for _ in range(3)]
    path = os.path.join(checkpoint_dir, "checkpoint.npz")
    save_checkpoint(path, params, optimizer, 3)
    size_mib = os.path.getsize(path) / 2 ** 20
    want = float(train.train_step_fast(params, optimizer, static, copts, target))
    fresh, fresh_static, fresh_opt = start()
    _, _, step = load_checkpoint(path, fresh, fresh_opt)
    got = float(train.train_step_fast(fresh, fresh_opt, fresh_static, copts, target))
    os.remove(path)
    if step != 3 or got != want:
        raise RuntimeError(f"the reloaded fourth step's loss {got!r} is not {want!r}")
    return {"render": "K1 render_forward_fast", "volume": n, "image": size,
            "cuda_event_ms": event_ms, "cuda_event_times": event_times, "host_ms": host_ms,
            "stopwatch_ms": sw_ms, "phase_timer_ms": pt_ms,
            "trace": {"file": os.path.relpath(prof.trace_path, REPO), "events": len(events),
                      "kernel_events": len(kernels),
                      "march_kernel_us": [e.get("dur") for e in marches],
                      "key_averages_device_ms": device_ms,
                      "traced_render_event_ms": traced_ms, "traced_host_ms": traced_host_ms},
            "checkpoint": {"volume": cn, "image": [ctx.COMPARE["width"], ctx.COMPARE["height"]],
                           "losses": losses, "fourth_loss": want, "fourth_loss_reloaded": got,
                           "bit_equal": True, "file_mib": size_mib,
                           "seconds": time.perf_counter() - t0},
            "seconds": time.perf_counter() - t_phase}


# the bricked rehearsal's worlds of phase 19: (ranks, backend, at full
# width, bands of image rows); a brick a rank over the whole image in the
# first three, the third at full width (multihost.FULL), 4 ranks on the one
# card; then rows x bricks worlds, rank (r, b) marching brick b over band r:
# 2 x 1 at 12^3 and 2 x 2 at full width
BRICK_WORLDS = ((1, "nccl", False, 1), (2, "gloo", False, 1), (4, "gloo", True, 1),
                (2, "gloo", False, 2), (4, "gloo", True, 2))
BRICK_FORMS = {"unlit": ("K7_transmittance", "K7_segment", "K7_scatter"),
               "lit": ("K7_transmittance", "K7_segment_lit", "K7_scatter_lit"),
               "lookup": ("K7_transmittance", "K7_segment_lit", "K7_scatter_lookup")}
RANK_IMAGE_TOL = 1e-6    # of scale: the ranks' image against the one-process one's (1 x W)
RANK_GRAD_TOL = 1e-5     # of scale: the gradient segment's atomic adds land in any order
RANK_LOSS_TOL = 1e-6     # relative


def bricked_rehearsal_cells(ctx, rehearsals) -> dict:
    """Each bricked rehearsal (``multihost.run_demo(bricks=..., bands=R)``,
    rank (r, b) marching brick b of B over band r of R) against the
    one-process bricked kernels on ``make_mesh(B)`` of the same card over
    the whole image, on the same cases (``multihost.brick_demo_cases``):
    every rank's image within RANK_IMAGE_TOL of scale, and to the bit on a
    rows x bricks world (R > 1); its entry record equal to phase 1's on the
    same brick and band; its gradients for the step's cotangent and its
    kernel step's gradients within RANK_GRAD_TOL of scale, the loss within
    RANK_LOSS_TOL; every rank launched each K7 form of its case
    (``BRICK_FORMS``), 2 a forward and 3 a step. Each rank held only its
    brick's rows (``rows``) and reports its peak MiB. The ranks' forward and
    step ms beside the one process's on the same bricks
    (``multihost.one_process_ms``; both ``multihost.wall_ms``, the median of
    5 warm calls): on one card that is the collectives' cost (gloo's host
    copies) and the worlds' sharing of the card, not scaling."""
    import torch

    from volume_renderer_tpu_torch import train
    from volume_renderer_tpu_torch.ops import cuda_bricks
    from volume_renderer_tpu_torch.ops.vjp import GRID_KEYS
    from volume_renderer_tpu_torch.parallel import bricks, multihost
    from volume_renderer_tpu_torch.parallel.mesh import make_mesh

    def err_of_scale(got, want):
        got, want = got.to(ctx.dev).double(), want.to(ctx.dev).double()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"{got.shape} against {want.shape}, or not finite")
        return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)

    def joined(results, case, step, key):
        """A key's gradient: a grid's parts joined over the first band's
        ranks, one a brick (run_demo held every band's equal to them)."""
        parts = [r[case][step]["grads"][key] for r in results[:len(results) // results[0]["bands"]]]
        return bricks.assemble(parts) if key in GRID_KEYS else parts[0]

    def grads_err(name, results, case, step, want):
        errs = {}
        for key, value in want.items():
            value = bricks.assemble(value) if isinstance(value, list) else value
            errs[key] = err_of_scale(joined(results, case, step, key), value)
            if errs[key] > RANK_GRAD_TOL:
                raise RuntimeError(f"{name} {step} {key}: {errs[key]:.3e} of scale off the "
                                   "one-process bricked kernels")
        return errs

    cells = {}
    for (ranks, backend, spec, n_bands), (results, seconds) in rehearsals.items():
        n_bricks = ranks // n_bands
        name = (f"{ranks}_{backend}_{spec.volume}" if n_bands == 1
                else f"{n_bands}x{n_bricks}_{backend}_{spec.volume}")
        mesh = make_mesh(n_bricks, ctx.dev)
        cell = {"backend": backend, "ranks": ranks, "bands": n_bands, "bricks": n_bricks,
                "mesh": results[0]["mesh"], "volume": spec.volume,
                "image": [spec.width, spec.height], "noise": spec.noise,
                "seconds": seconds, "rank_peak_mib": [r["peak_mib"] for r in results]}
        for case, (scene, opts, target, start) in multihost.brick_demo_cases(ctx.dev,
                                                                             spec).items():
            what = f"{name} {case}"
            image = bricks.render_forward_bricked_fast(scene, opts, mesh=mesh)
            split = bricks.split_bricks(scene, mesh)
            out = {"rank_launches": [r[case]["launches"] for r in results],
                   "rank_forward_ms": [r[case]["forward_ms"] for r in results],
                   "image_err_of_scale": [],
                   **multihost.one_process_ms(scene, opts, target, start, mesh)}
            band_rows = opts.height // n_bands
            # a forward (phase 1, phase 2) and a step (+ the segment)
            launches = {k: 1 if k == BRICK_FORMS[case][2] else 2 for k in BRICK_FORMS[case]}
            for r in results:
                if (r["band"], r["brick"], r["bands"]) != (*divmod(r["rank"], n_bricks), n_bands):
                    raise RuntimeError(f"{what}: rank {r['rank']} is band {r['band']} and brick "
                                       f"{r['brick']} of {r['bands']} bands")
                rows = {k: spec.volume // n_bricks for k in r[case]["rows"]}
                if r[case]["rows"] != rows:
                    raise RuntimeError(f"{what}: rank {r['rank']} held {r[case]['rows']} rows, "
                                       f"not its own {spec.volume // n_bricks}")
                out["image_err_of_scale"].append(err_of_scale(r[case]["image"], image))
                if (out["image_err_of_scale"][-1] > RANK_IMAGE_TOL
                        or (n_bands > 1 and not torch.equal(r[case]["image"].to(ctx.dev), image))):
                    raise RuntimeError(f"{what}: rank {r['rank']}'s image is "
                                       f"{out['image_err_of_scale'][-1]:.3e} of scale off")
                _, entry = cuda_bricks.brick_transmittance(
                    split.bricks[r["brick"]], opts, y_offset=r["band"] * band_rows,
                    n_rows=band_rows)
                if not (torch.equal(r[case]["entry"]["step"].to(ctx.dev), entry.step)
                        and torch.equal(r[case]["entry"]["state"].to(ctx.dev), entry.state)):
                    raise RuntimeError(f"{what}: rank {r['rank']}'s entry record is not "
                                       "phase 1's on its brick and band")
                if r[case]["launches"] != launches:
                    raise RuntimeError(f"{what}: rank {r['rank']} launched "
                                       f"{r[case]['launches']}, not {launches}")
            g = 2.0 * (image - target)
            _, want = bricks.voxel_grads_bricked_fast(split, opts, g)
            out["grads_err_of_scale"] = grads_err(what, results, case, "grads", want)
            params, static = bricks.split_params_bricked(train.merge_params(start, scene), mesh)
            optimizer = torch.optim.Adam(bricks.param_leaves(params), lr=multihost.DEMO["lr"])
            loss = float(bricks.train_step_fast_bricked(params, optimizer, static, opts, target))
            want = {k: [p.grad for p in v] if isinstance(v, list) else v.grad
                    for k, v in params.items()}
            out["step_grads_err_of_scale"] = grads_err(what, results, case, "fast", want)
            out["loss"] = loss
            out["loss_err"] = max(abs(r[case]["fast"]["loss"] - loss) / loss for r in results)
            if out["loss_err"] > RANK_LOSS_TOL:
                raise RuntimeError(f"{what}: the ranks' loss is {out['loss_err']:.3e} off {loss}")
            out["rank_step_ms"] = [r[case]["step_ms"] for r in results]
            if spec.fused:  # the plain step through autograd: the same image and loss
                fused = results[0][case]["fused"]
                out["fused_loss_err"] = abs(fused["loss"] - loss) / loss
                if out["fused_loss_err"] > RANK_LOSS_TOL:
                    raise RuntimeError(f"{what}: the fused step's loss {fused['loss']} is not "
                                       f"the kernels' {loss}")
                out["fused_grads_vs_kernels_err_of_scale"] = {
                    key: err_of_scale(joined(results, case, "fused", key),
                                      joined(results, case, "fast", key))
                    for key in fused["grads"]}
            cell[case] = out
        cells[name] = cell
    return cells


EXAMPLES = ("example1", "example1_grad", "example2", "example3", "example4", "example_inverse",
            "example_inverse_lit", "paper_illustration_multiple_channels",
            "paper_scale_permutations")
EXAMPLE_CUTS = {"example_inverse": ["--steps", "3"], "example_inverse_lit": ["--steps", "3"]}


def examples_phase(ctx, out_dir: str) -> dict:
    """Every ported example (volume_renderer_tpu_torch/examples) at its
    defaults on the card, the inverse ones with --steps 3 (EXAMPLE_CUTS),
    writing under ``out_dir``: the launches by mode each made, counted from
    0, its seconds, and every image it saved, which must be finite and not
    all zero. ``example_inverse`` runs the plain replay (``train.train_step``)
    and must launch nothing; every other example must launch a kernel."""
    import contextlib
    import importlib
    import io

    import torch

    from volume_renderer_tpu_torch.ops import cuda_march

    out = {}
    for name in EXAMPLES:
        mod = importlib.import_module(f"volume_renderer_tpu_torch.examples.{name}")
        saved = {}
        save_image = mod.save_image

        def capture(path, img, save_image=save_image, saved=saved):
            img = np.asarray(img, np.float32)
            saved[os.path.relpath(path, out_dir)] = {
                "shape": list(img.shape), "finite": bool(np.isfinite(img).all()),
                "max": float(np.abs(img).max()) if img.size else 0.0}
            save_image(path, img)

        argv = EXAMPLE_CUTS.get(name, []) + ["--out", os.path.join(out_dir, name)]
        mod.save_image = capture
        cuda_march.reset_launch_counts()
        stdout = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(stdout):
                mod.main(argv)
            torch.cuda.synchronize()
        finally:
            mod.save_image = save_image
        launches = {k: v for k, v in cuda_march.LAUNCHES_BY_MODE.items() if v}
        bad = [path for path, img in saved.items() if not (img["finite"] and img["max"] > 0)]
        if not saved or bad:
            raise RuntimeError(f"example {name} saved {sorted(saved)}; empty or not finite: {bad}")
        if (name == "example_inverse") != (not launches):
            raise RuntimeError(f"example {name} launched {launches}")
        out[name] = {"argv": argv, "seconds": time.perf_counter() - t0, "launches": launches,
                     "images": saved, "stdout_tail": stdout.getvalue().splitlines()[-3:]}
        torch.cuda.empty_cache()
    return {"examples": out, "cut": {k: v for k, v in EXAMPLE_CUTS.items()}}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write every JSON line to this file")
    parser.add_argument("--parent", metavar="DIR",
                        help="a directory holding another version of volume_renderer_tpu_torch/ "
                             "(e.g. the parent commit's): its K1-K7, K6L, K2L and the lookup "
                             "segment are timed in turns with the checkout's (phase 11)")
    parser.add_argument("--turn", action="store_true",
                        help="phase 11's turns: build, then for each line read on stdin time "
                             "the parts it names (march: K1-K6, bricks: K7, lit: the lit K7 "
                             "forms, lookup: K6L and the lookup gradient segment, k2l: K2L; "
                             "turn: all five) and print one JSON line")
    parser.add_argument("--grids-ref", metavar="FILE",
                        help="with --turn: the lookup part's grids of the first turn that "
                             "finds no FILE are written there, and every other turn's are held "
                             "against them (default: a file of this process's own)")
    parser.add_argument("--repo", metavar="DIR", default=REPO,
                        help="import the port from DIR instead of the checkout around this script")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.repo))

    from volume_renderer_tpu_torch import (
        Camera, LightSource, RenderSettings, Scene, StereoRenderMode, Volume, VolumeRenderer,
        henyey_greenstein_lut)
    from volume_renderer_tpu_torch import train
    from volume_renderer_tpu_torch.ops import (
        _build, brick_march, cuda_bricks, cuda_grads, cuda_march)
    from volume_renderer_tpu_torch.ops.cuda_grads import (
        grad_mode, march_backward, transfer_grads_fast, voxel_grads_fast)
    from volume_renderer_tpu_torch.ops.cuda_march import kernel_mode, render_forward_fast
    from volume_renderer_tpu_torch.ops.forward import render_forward, render_rows
    from volume_renderer_tpu_torch.ops.vjp import replay_backward
    from volume_renderer_tpu_torch.parallel import bricks
    from volume_renderer_tpu_torch.parallel.mesh import make_mesh

    lines = []
    t_start = time.perf_counter()

    def record(obj):
        if "phase" in obj:
            obj["elapsed_s"] = time.perf_counter() - t_start
        lines.append(obj)
        emit(obj)

    dev = torch.device(DEVICE)
    kernel_path = "cuda" if dev.type == "cuda" else "plain"
    kind = torch.cuda.get_device_name(0)

    # ---- 1. device and build ------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    threads = kernel_threads(args.repo)
    ptxas = {name: ptxas_by_kernel(_build.build_log(name), strict=not args.turn,
                                   threads=threads)
             for name in _build.SOURCES}
    # every kernel keeps every value in registers
    spilled = {k: v for name in _build.SOURCES for k, v in ptxas[name].items()
               if v["spill_store_bytes"]}
    if spilled and not args.turn:  # a turn may time an older version
        raise RuntimeError(f"ptxas spills in a kernel: {spilled}")
    record({"phase": "device", "kind": kind, "nvidia_smi": smi_line,
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": build_s,
            "ptxas": ptxas})

    max_err = {"K1": 0.0, "K4": 0.0, "K5": 0.0}

    def check(name, got, want, atol, rtol, mode):
        got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
        assert got.shape == want.shape, (name, got.shape, want.shape)
        assert np.isfinite(got).all(), f"{name}: non-finite values"
        err = float(np.abs(got - want).max())
        if mode is not None:
            max_err[mode] = max(max_err[mode], err)
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=name)
        # K1 blends as sample() does, and K4's tap fetch reads the voxels of
        # seven sample() calls once each and blends them as those do: their
        # images are their plain versions'
        if mode in ("K1", "K4") and err != 0.0:
            raise RuntimeError(f"{name}: the {mode} kernel is {err:.3e} off its plain version")
        return err

    # ---- scenes: the flagship gaussian shell (__graft_entry__.py) -------
    def shell(n, noise=0.0, shape=None):
        """The shell in an n^3 volume or, with ``shape`` (D, H, W), an
        ellipsoidal one filling that box alike."""
        if shape is None:
            i = torch.arange(n, dtype=torch.float32, device=dev)
            c = (n - 1) / 2.0
            r2 = ((i[None, None, :] - c) ** 2 + (i[None, :, None] - c) ** 2
                  + (i[:, None, None] - c) ** 2) / (c * c)
        else:
            r2 = 0.0
            for axis, m in enumerate(shape):
                c = (m - 1) / 2.0
                i = torch.arange(m, dtype=torch.float32, device=dev).reshape(
                    [m if a == axis else 1 for a in range(3)])
                r2 = r2 + (i - c) ** 2 / (c * c)
        vol = torch.exp(-4.0 * (torch.sqrt(r2) - 0.6) ** 2)
        if noise:
            # Seeded multiplicative noise for the gradient phases. On the
            # smooth shell the normal equals the view direction over the
            # whole camera-facing cap, where the angle adjoint amplifies
            # rounding a thousandfold; real volumes are not that smooth.
            gen = torch.Generator(device=dev)
            gen.manual_seed(n)
            vol = vol * (1.0 + noise * (torch.rand(vol.shape, generator=gen, device=dev) - 0.5))
        return vol.contiguous()

    def flagship(n, mode, n_lights=1, ab_aliased=True, re_aliased=False, noise=0.0, shape=None,
                 element_size=(1.0, 1.0, 1.0), rotate=(125, 25, 0), ab_other_shape=False,
                 grad_other_shape=False, re_other_shape=False):
        """``ab_other_shape``: absorption at half the emission's height and
        width (a fetch, and with gradients a carry, of its own).
        ``grad_other_shape`` (K5): the gradient volumes of a volume at half
        the emission's height and width, so that K5 is not packed.
        ``re_other_shape``: reflection at half the emission's height and
        width (K2L's unpaired form beside the pack)."""
        em = shell(n, noise, shape)
        ramp = torch.linspace(0.5, 1.0, em.shape[2], device=dev)[None, None, :]
        ab = None if ab_aliased else Volume.create((em * ramp).contiguous(), element_size)
        if ab_other_shape:
            ab = Volume.create((em[:, ::2, ::2] * 0.9).contiguous(), element_size)
        lit = {}
        if mode != "K1":
            lit = dict(illumination=henyey_greenstein_lut(32),
                       light_positions=torch.tensor([[2.0, 3.0, -1.5], [-1.0, 2.0, 2.0]],
                                                    device=dev)[:n_lights].contiguous(),
                       light_colors=torch.tensor([[1.0, 1.0, 1.0], [0.5, 0.6, 1.0]],
                                                 device=dev)[:n_lights].contiguous())
            if not re_aliased:
                lit["reflection"] = Volume.create(
                    (em[:, ::2, ::2] * 0.8).contiguous() if re_other_shape else em.clone(),
                    element_size)
            if mode == "K5":
                src = em[:, ::2, ::2].contiguous() if grad_other_shape else em
                lit.update(zip(("gradient_x", "gradient_y", "gradient_z"),
                               Volume.create(src).gradient_volumes()))
        return Scene(
            emission=Volume.create(em, element_size), absorption=ab,
            camera=Camera.create(focal_length=3.0, distance_to_object=6.0).rotate(*rotate),
            settings=RenderSettings.create(factor_emission=1.0, factor_reflection=0.4,
                                           factor_absorption=0.6, color=(1.0, 0.9, 0.8),
                                           opacity_threshold=0.95),
            **lit)

    # tolerances: the kernel repeats the plain version's arithmetic in the
    # same order, without FMA contraction (-fmad=false); what may remain are
    # acosf/expf/rsqrtf ulps, carried when lit through the normal into the LUT
    tol = {"K1": (1e-5, 1e-4), "K4": (3e-5, 3e-4), "K5": (3e-5, 3e-4)}

    # Two lit scenes for the branches of the shared tap fetch
    # (csrc/march_common.cuh), the volumes of tests/test_torch_march.py: a
    # non-cubic anisotropic (36, 24, 64) volume, whose y taps lie 1.33 voxels
    # out (a far axis) and whose z taps 0.56 (near: window slots 0 and 3 both
    # in use); and a 48^3 volume under a camera near the z axis, whose rays
    # enter through a face and leave through the side faces and edges, where
    # corners and taps clamp.
    ANISOTROPIC = dict(ab_aliased=False, noise=0.05, shape=(36, 24, 64),
                       element_size=(1.0, 1.0, 1.6), rotate=(70, 20, 5))
    FACES = dict(ab_aliased=False, noise=0.05, rotate=(3, 2, 0))

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def median_ms(fn, reps=5):
        fn()  # warm
        torch.cuda.synchronize()
        times = [timed(fn)[1] for _ in range(reps)]
        return float(np.median(times)), times

    def host_ms(fn, reps=5):
        """The host's time in ``fn`` from an idle card, waits for the card
        inside it included (perf_counter, warm, median of ``reps``)."""
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return float(np.median(times))

    def brick_scene(n, rot, ab_aliased=False, factor_absorption=0.6, opacity_threshold=0.95,
                    ab_other_shape=False):
        """The noisy unlit flagship scene under another camera and settings."""
        scene = flagship(n, "K1", ab_aliased=ab_aliased, noise=0.05, ab_other_shape=ab_other_shape)
        return scene.replace(
            camera=Camera.create(focal_length=3.0, distance_to_object=6.0).rotate(*rot),
            settings=RenderSettings.create(factor_emission=1.0, factor_reflection=0.4,
                                           factor_absorption=factor_absorption,
                                           color=(1.0, 0.9, 0.8),
                                           opacity_threshold=opacity_threshold))

    def digest(tensors):
        h = hashlib.sha1()
        for t in tensors:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()

    def cotangent(height, width, seed):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return torch.randn((height, width, 3), generator=gen, device=dev) * 1e-3

    def transfer_scene(scene, params):
        return scene.replace(settings=dataclasses.replace(scene.settings, **params))

    def transfer_step(params, optimizer, scene, opts, target):
        """One step of a transfer-function fit: the grids stay fixed."""
        with torch.no_grad():
            merged = transfer_scene(scene, params)
            img = render_forward_fast(merged, opts)
            resid = img - target
            _, grads = transfer_grads_fast(merged, opts, 2.0 * resid, image=img)
            for key, p in params.items():
                p.grad = grads[key]
        optimizer.step()
        return torch.sum(resid ** 2)

    def transfer_fit(scene, opts):
        """A transfer-function fit's first state on ``scene``: the target (its
        own render), the factors and color off by 30 % and 20 % as leaf
        tensors, and Adam over them; a step is
        ``transfer_step(params, optimizer, scene, opts, target)``."""
        target = render_forward_fast(scene, opts)
        off = {"factor_emission": 1.3, "factor_absorption": 1.3, "color": 0.8}
        params = {k: (getattr(scene.settings, k) * f).detach().clone().requires_grad_(True)
                  for k, f in off.items()}
        return params, torch.optim.Adam(list(params.values()), lr=TRAIN_LR["K2"]), target

    def backward_planes(fn):
        """``(fn(), planes)``: the per-ray planes of every backward launch in
        ``fn``, copied where ops.cuda_grads closes them (parameter_grads,
        wrapped for the call; a version of the port whose wrapper closes
        them there, as every version has)."""
        seen, close = [], cuda_grads.parameter_grads

        def keep(scene, opts, g, planes):
            seen.append(planes.clone())
            return close(scene, opts, g, planes)

        cuda_grads.parameter_grads = keep
        try:
            return fn(), seen
        finally:
            cuda_grads.parameter_grads = close

    def forward_turn(mode):
        """The forward kernel of ``mode`` (K1, K4 or K5) at 256^3 / 512^2 and
        512^3 / 1024^2, timed as phase 7 times it, with a digest of each
        image; K5's pack also alone, where the port packs."""
        out = {}
        pack = getattr(cuda_march, "pack_lookup", None) if mode == "K5" else None
        for cfg in (MAIN, BIG):
            scene = flagship(cfg["volume"], mode, ab_aliased=False)
            opts = scene.options(cfg["image"], cfg["image"])
            img = render_forward_fast(scene, opts)
            cell = out[f"{mode}_{cfg['volume']}_{cfg['image']}"] = {
                "ms": median_ms(lambda: render_forward_fast(scene, opts))[0],
                "image_sha1": digest([img])}
            if pack is not None:
                cell["pack_ms"] = median_ms(lambda: pack(scene))[0]
            del scene, img
            torch.cuda.empty_cache()
        return out

    def grads_turn(mode):
        """The scatter kernel of ``mode`` (K3 or K6) at 256^3 / 512^2 from the
        first training step's state: the backward alone, the forward +
        backward pair and the training step, timed as phase 7 times them."""
        scene = flagship(MAIN["volume"], "K4" if mode == "K6" else "K1", ab_aliased=False,
                         noise=0.05)
        opts = scene.options(MAIN["image"], MAIN["image"])
        with torch.no_grad():
            target = render_forward_fast(scene, opts)
            params, static_scene = train.split_params(scene)
            params["emission"].mul_(1.3).add_(0.05)
            merged = train.merge_params(params, static_scene)
            img = render_forward_fast(merged, opts)
            g = 2.0 * (img - target)

            def fwd_bwd():
                image = render_forward_fast(merged, opts)
                return voxel_grads_fast(merged, opts, 2.0 * (image - target), image=image)

            ms = {"backward_ms": median_ms(lambda: march_backward(merged, opts, g, img))[0],
                  "fwd_bwd_ms": median_ms(fwd_bwd)[0]}
        optimizer = torch.optim.Adam(list(params.values()), lr=TRAIN_LR[mode])
        ms["train_step_ms"] = median_ms(
            lambda: train.train_step_fast(params, optimizer, static_scene, opts, target))[0]
        return {f"{mode}_{MAIN['volume']}_{MAIN['image']}": ms}

    def params_turn(lit):
        """K2 (unlit at 256^3 / 512^2 and 512^3 / 1024^2, lit at 256^3 /
        512^2) from the first training step's state, as phase 7 times it: the
        backward alone, transfer_grads_fast forward + backward and the
        transfer-fit step with Adam; unlit the pair's pack alone, where the
        port packs; with a digest of the per-ray planes and the gradients,
        which have no atomics to vary."""
        pack = None if lit else getattr(cuda_grads, "pack_pair", None)
        out = {}
        for cfg in (MAIN,) if lit else (MAIN, BIG):
            scene = flagship(cfg["volume"], "K4" if lit else "K1", ab_aliased=False, noise=0.05)
            opts = scene.options(cfg["image"], cfg["image"])
            with torch.no_grad():
                target = render_forward_fast(scene, opts)
                params, static_scene = train.split_params(scene)
                params["emission"].mul_(1.3).add_(0.05)
                merged = train.merge_params(params, static_scene)
                img = render_forward_fast(merged, opts)
                g = 2.0 * (img - target)

                def bwd():
                    return march_backward(merged, opts, g, img, scatter=False)

                def fwd_bwd():
                    image = render_forward_fast(merged, opts)
                    return transfer_grads_fast(merged, opts, 2.0 * (image - target), image=image)

                grads, planes = backward_planes(bwd)
                cell = {"backward_ms": median_ms(bwd)[0], "fwd_bwd_ms": median_ms(fwd_bwd)[0],
                        "planes_sha1": digest(planes + [grads[k] for k in sorted(grads)])}
                if pack is not None:
                    cell["pack_ms"] = median_ms(lambda: pack(merged))[0]
            tparams, optimizer, target = transfer_fit(scene, opts)
            cell["train_step_ms"] = median_ms(
                lambda: transfer_step(tparams, optimizer, scene, opts, target))[0]
            out[f"K2{'_lit' if lit else ''}_{cfg['volume']}_{cfg['image']}"] = cell
        return out

    def march_turn():
        """K1, K4 and K5 (forward_turn), K3 and K6 (grads_turn), K2
        (params_turn)."""
        return {"ptxas": {name: ptxas[name] for name in ("march_fwd", "march_bwd")},
                **forward_turn("K1"), **forward_turn("K4"), **forward_turn("K5"),
                **grads_turn("K3"), **grads_turn("K6"), **params_turn(False),
                **params_turn(True)}

    def brick_turn():
        """K7 with 4 bricks at 256^3 / 512^2 on the first bricked training
        step's state, timed as phase 10 times it: each launch form over all
        bricks (phase 2 and the gradient segment from phase 1's outputs,
        computed outside the timed calls), phase 1 also on the dense scene
        (factor_absorption 4, threshold 0.3), the bricked forward, forward +
        backward and training step; the host's time in phase 2's four calls
        and in the bricked forward; with digests of the bricked image, of the
        bricks' exit opacities, and of phase 1's opacities and entry records
        on both scenes. Takes a port whose phase 1 returns the entry record
        and one whose phase 1 does not."""
        size = MAIN["image"]
        scene = brick_scene(MAIN["volume"], (125, 25, 0))
        opts = scene.options(size, size)
        out = {"ptxas": {name: ptxas[name] for name in ("brick_fwd", "brick_bwd")}}
        with torch.no_grad():
            target = render_forward_fast(scene, opts)
            bparams, bstatic = bricks.split_params_bricked(scene, make_mesh(BRICKS))
            for p in bparams["emission"]:
                p.mul_(1.3).add_(0.05)
            split = bricks.merge_params_bricked(bparams, bstatic)
            fwd = bricks._forward(split, opts, 0.0, fast=True)
            g = 2.0 * (fwd.image - target)
            up_dots = [u.contiguous() for u in bricks._upstream(
                [brick_march.own_dot(g, own) for own in fwd.own], fwd.ascending, torch.cumsum,
                0.0)]
            w_ins = [w.contiguous() for w in fwd.w_in]
            phase1 = [cuda_bricks.brick_transmittance(b, opts) for b in split.bricks]
            records = [p[1:] if isinstance(p, tuple) else () for p in phase1]  # () for an older port
            w_outs = [cuda_bricks.brick_segment(b, opts, 0.0, w, *r)[1]
                      for b, w, r in zip(split.bricks, w_ins, records)]
            out["image_sha1"], out["w_out_sha1"] = digest([fwd.image]), digest(w_outs)
            dense = bricks.split_bricks(
                brick_scene(MAIN["volume"], (125, 25, 0), factor_absorption=4.0,
                            opacity_threshold=0.3), make_mesh(BRICKS))
            for name, p1 in (("phase1", phase1), ("dense_phase1", [
                    cuda_bricks.brick_transmittance(b, opts) for b in dense.bricks])):
                ws = [p[0] if isinstance(p, tuple) else p for p in p1]
                out[f"{name}_w_sha1"] = digest(ws)
                out[f"{name}_entry_sha1"] = digest(
                    [t for p in p1 if isinstance(p, tuple) for t in (p[1].step, p[1].state)])
            ms = {
                "transmittance": median_ms(lambda: [cuda_bricks.brick_transmittance(b, opts)
                                                    for b in split.bricks])[0],
                "transmittance_dense": median_ms(lambda: [
                    cuda_bricks.brick_transmittance(b, opts) for b in dense.bricks])[0],
                "segment": median_ms(lambda: [
                    cuda_bricks.brick_segment(b, opts, 0.0, w, *r)
                    for b, w, r in zip(split.bricks, w_ins, records)])[0],
                "segment_host": host_ms(lambda: [
                    cuda_bricks.brick_segment(b, opts, 0.0, w, *r)
                    for b, w, r in zip(split.bricks, w_ins, records)]),
                # the part of it that checks the four records' keys
                "record_check_host": host_ms(lambda: [
                    r[0].check(brick_march.Entry.key(b, opts, 0.0))
                    for b, r in zip(split.bricks, records) if r]),
                "scatter": median_ms(lambda: [
                    cuda_bricks.brick_gradients(b, opts, 0.0, g, fwd.image, w, u, *r)
                    for b, w, u, r in zip(split.bricks, w_ins, up_dots, records)])[0],
                "bricked_forward": median_ms(
                    lambda: bricks.render_forward_bricked_fast(split, opts))[0],
                "bricked_forward_host": host_ms(
                    lambda: bricks.render_forward_bricked_fast(split, opts)),
                "bricked_fwd_bwd": median_ms(
                    lambda: bricks.voxel_grads_bricked_fast(split, opts, g))[0],
            }
        optimizer = torch.optim.Adam(bricks.param_leaves(bparams), lr=TRAIN_LR["K3"])
        ms["bricked_train_step"] = median_ms(lambda: bricks.train_step_fast_bricked(
            bparams, optimizer, bstatic, opts, target))[0]
        out["ms"] = ms
        return out

    def lit_turn(grids_dir):
        """The lit K7 forms with 4 bricks at 256^3 / 512^2, timed as phase 10
        times them (CUDA events, warm, median of 5), each from phase 1's
        outputs computed outside the timed calls: lit phase 2 over all bricks
        on K6's noisy scene and on K5's (the lookup form, with its pack where
        the port packs; the pack alone), the lit gradient segment, the lit
        bricked forward of both scenes and the lit bricked training step; with
        a digest of every brick's lit contribution and exit opacity on each
        scene. The lit segment's per-brick grids go to a file under
        ``grids_dir`` (its atomic adds land in any order, so another version's
        are held within 1e-5 of scale, not to the bit)."""
        size = MAIN["image"]
        ms, out = {}, {"ptxas": {name: ptxas[name] for name in ("brick_fwd", "brick_bwd")}}
        lit4 = flagship(MAIN["volume"], "K4", ab_aliased=False, noise=0.05)
        lit5 = flagship(MAIN["volume"], "K5", ab_aliased=False)
        opts = lit4.options(size, size)
        g = cotangent(size, size, seed=31)
        pack = getattr(cuda_bricks, "pack_window", None)
        with torch.no_grad():
            for name, scene in (("otf", lit4), ("lookup", lit5)):
                split = bricks.split_bricks(scene, make_mesh(BRICKS))
                fwd = bricks._forward(split, opts, 0.0, fast=True)
                w_ins = [w.contiguous() for w in fwd.w_in]
                states = list(zip(split.bricks, w_ins, fwd.entry))
                out[f"{name}_segment_sha1"] = digest([
                    t for b, w, e in states for t in cuda_bricks.brick_segment(b, opts, 0.0, w, e)])
                out[f"{name}_image_sha1"] = digest([fwd.image])
                ms[f"segment_lit_{name}"] = median_ms(lambda: [
                    cuda_bricks.brick_segment(b, opts, 0.0, w, e) for b, w, e in states])[0]
                ms[f"bricked_forward_{name}"] = median_ms(
                    lambda: bricks.render_forward_bricked_fast(split, opts))[0]
                if name == "lookup":
                    if pack is not None:
                        ms["pack_lookup"] = median_ms(lambda: [pack(b) for b in split.bricks])[0]
                    continue
                up = [u.contiguous() for u in bricks._upstream(
                    [brick_march.own_dot(g, own) for own in fwd.own], fwd.ascending,
                    torch.cumsum, 0.0)]
                grads = [cuda_bricks.brick_gradients(b, opts, 0.0, g, fwd.image, w, u, e)
                         for (b, w, e), u in zip(states, up)]
                out["lit_grids"] = os.path.join(grids_dir, "lit_grids.pt")
                torch.save([{k: grads[i][k].cpu() for k in ("emission", "absorption", "reflection")}
                            for i in range(len(grads))], out["lit_grids"])
                ms["scatter_lit"] = median_ms(lambda: [
                    cuda_bricks.brick_gradients(b, opts, 0.0, g, fwd.image, w, u, e)
                    for (b, w, e), u in zip(states, up)])[0]
                del grads
            target = render_forward_fast(lit4, opts)
            bparams, bstatic = bricks.split_params_bricked(lit4, make_mesh(BRICKS))
            for p in bparams["emission"]:
                p.mul_(1.3).add_(0.05)
        optimizer = torch.optim.Adam(bricks.param_leaves(bparams), lr=TRAIN_LR["K6"])
        ms["bricked_train_step_lit"] = median_ms(lambda: bricks.train_step_fast_bricked(
            bparams, optimizer, bstatic, opts, target))[0]
        out["ms"] = ms
        return out

    def grids_err(got, want):
        """max |got - want| over a key's grids (a dict, or a list of dicts,
        one a brick) as a share of the largest |want|, by key."""
        got, want = ([got], [want]) if isinstance(want, dict) else (got, want)
        out = {}
        for key in want[0]:
            scale = max(max(float(w[key].abs().max()) for w in want), 1e-30)
            out[key] = max(float((a[key].double() - b[key].double()).abs().max())
                           for a, b in zip(got, want)) / scale
        return out

    def lookup_turn(grids_ref):
        """K6L and the lookup gradient segment on K5's noisy scene from the
        first training step's state (emission x 1.3 + 0.05 against the true
        scene), timed as phases 7 and 10 time them (CUDA events, warm, median
        of 5): at 256^3 / 512^2 K6L's backward alone, forward + backward and
        train_step_fast; with 4 bricks the lookup gradient segment over all
        bricks, from phase 1's outputs computed outside the timed calls, and
        the lookup bricked training step. K6L's grids and the segment's
        per-brick grids are written to ``grids_ref`` by the first turn that
        finds no file there, and every other turn's are held against them
        within TURN_GRID_TOL of scale (its atomic adds land in any order)."""
        size = MAIN["image"]
        scene = flagship(MAIN["volume"], "K5", ab_aliased=False, noise=0.05)
        opts = scene.options(size, size)
        ms = {}
        with torch.no_grad():
            target = render_forward_fast(scene, opts)
            params, static_scene = train.split_params(scene)
            params["emission"].mul_(1.3).add_(0.05)
            merged = train.merge_params(params, static_scene)
            img = render_forward_fast(merged, opts)
            g = 2.0 * (img - target)
            grids = {"K6L": {k: v.cpu() for k, v in march_backward(merged, opts, g, img).items()
                             if v.dim() == 3}}

            def fwd_bwd():
                image = render_forward_fast(merged, opts)
                return voxel_grads_fast(merged, opts, 2.0 * (image - target), image=image)

            ms["K6L_backward"] = median_ms(lambda: march_backward(merged, opts, g, img))[0]
            ms["K6L_fwd_bwd"] = median_ms(fwd_bwd)[0]
            split = bricks.split_bricks(merged, make_mesh(BRICKS))
            fwd = bricks._forward(split, opts, 0.0, fast=True)
            gb = 2.0 * (fwd.image - target)
            up = [u.contiguous() for u in bricks._upstream(
                [brick_march.own_dot(gb, own) for own in fwd.own], fwd.ascending,
                torch.cumsum, 0.0)]
            states = [(b, w.contiguous(), u, e)
                      for b, w, u, e in zip(split.bricks, fwd.w_in, up, fwd.entry)]

            def segment():
                return [cuda_bricks.brick_gradients(b, opts, 0.0, gb, fwd.image, w, u, e)
                        for b, w, u, e in states]

            grids["segment"] = [{k: v.cpu() for k, v in part.items() if v.dim() == 3}
                                for part in segment()]
            ms["scatter_lookup"] = median_ms(segment)[0]
            del split, fwd, states
        optimizer = torch.optim.Adam(list(params.values()), lr=TRAIN_LR["K6L"])
        ms["train_step_fast"] = median_ms(
            lambda: train.train_step_fast(params, optimizer, static_scene, opts, target))[0]
        bparams, bstatic = bricks.split_params_bricked(scene, make_mesh(BRICKS))
        with torch.no_grad():
            for p in bparams["emission"]:
                p.mul_(1.3).add_(0.05)
        boptimizer = torch.optim.Adam(bricks.param_leaves(bparams), lr=TRAIN_LR["K6L"])
        ms["bricked_train_step"] = median_ms(lambda: bricks.train_step_fast_bricked(
            bparams, boptimizer, bstatic, opts, target))[0]
        out = {"ptxas": {name: ptxas[name] for name in ("march_bwd", "brick_bwd")}, "ms": ms}
        if not os.path.exists(grids_ref):
            torch.save(grids, grids_ref)
            out["grids_written"] = grids_ref
            return out
        want = torch.load(grids_ref)
        err = {part: grids_err(grids[part], want[part]) for part in want}
        out["grids_err_of_scale_vs_ref"] = err
        bad = {f"{part} {k}": e for part, es in err.items() for k, e in es.items()
               if not e <= TURN_GRID_TOL}
        if bad:
            raise RuntimeError(f"lookup turn: grids off the reference's beyond "
                               f"{TURN_GRID_TOL:g} of scale: {bad}")
        return out

    def k2l_turn():
        """K2L on K5's noisy scene at 256^3 / 512^2 from the first training
        step's state, timed as phase 7 times it (CUDA events, warm, median
        of 5): the backward call (K5's pack and, where the port packs one,
        the pair made inside it), the kernel alone (both made outside the
        timed call), transfer_grads_fast forward + backward, the
        transfer-fit step with Adam, and each pack alone; with a digest of
        the per-ray planes and the gradients, which have no atomics to
        vary."""
        size = MAIN["image"]
        scene = flagship(MAIN["volume"], "K5", ab_aliased=False, noise=0.05)
        opts = scene.options(size, size)
        pair_of = getattr(cuda_grads, "pack_lookup_pair", None)  # None in an older port
        with torch.no_grad():
            target = render_forward_fast(scene, opts)
            params, static_scene = train.split_params(scene)
            params["emission"].mul_(1.3).add_(0.05)
            merged = train.merge_params(params, static_scene)
            img = render_forward_fast(merged, opts)
            g = 2.0 * (img - target)
            made = {"packed": cuda_march.pack_lookup(merged)}
            if pair_of is not None:
                made["pair"] = pair_of(merged)

            def bwd():
                return march_backward(merged, opts, g, img, scatter=False)

            def fwd_bwd():
                image = render_forward_fast(merged, opts)
                return transfer_grads_fast(merged, opts, 2.0 * (image - target), image=image)

            grads, planes = backward_planes(bwd)
            ms = {"backward_ms": median_ms(bwd)[0],
                  "kernel_ms": median_ms(lambda: march_backward(merged, opts, g, img,
                                                                scatter=False, **made))[0],
                  "fwd_bwd_ms": median_ms(fwd_bwd)[0],
                  "pack_ms": median_ms(lambda: cuda_march.pack_lookup(merged))[0]}
            if pair_of is not None:
                ms["pair_pack_ms"] = median_ms(lambda: pair_of(merged))[0]
            sha1 = digest(planes + [grads[k] for k in sorted(grads)])
            del made
        tparams, optimizer, ttarget = transfer_fit(scene, opts)
        ms["train_step_ms"] = median_ms(
            lambda: transfer_step(tparams, optimizer, scene, opts, ttarget))[0]
        return {"ptxas": ptxas["march_bwd"], "ms": ms, "planes_sha1": sha1}

    if args.turn:  # a turn for each line on stdin, until it closes
        import tempfile
        emit({"phase": "ready"})
        grids_dir = tempfile.mkdtemp(prefix="chip_smoke_turn_")
        grids_ref = args.grids_ref or os.path.join(grids_dir, "lookup_grids.pt")
        for line in sys.stdin:
            # the line names the parts to time: "march", "bricks", "lit",
            # "lookup", "k2l"; "turn" all five
            parts = set(line.split()) or {"turn"}
            t_turn = time.perf_counter()
            out = {}
            if parts & {"turn", "march"}:
                out["march"] = march_turn()
            if parts & {"turn", "bricks"}:
                out["bricks"] = brick_turn()
            if parts & {"turn", "lit"}:
                out["lit"] = lit_turn(grids_dir)
            if parts & {"turn", "lookup"}:
                out["lookup"] = lookup_turn(grids_ref)
            if parts & {"turn", "k2l"}:
                out["k2l"] = k2l_turn()
            emit({"phase": "turn", "repo": os.path.abspath(args.repo), **out,
                  "seconds": time.perf_counter() - t_turn})
        return

    # imported here, not above: the turns may import an older port without them
    from volume_renderer_tpu_torch.api import planner
    from volume_renderer_tpu_torch.ops import cuda_slab, slab
    from volume_renderer_tpu_torch.ops.cuda_march import render_rows_fast

    def of_scale(name, got, want, limit=1e-5):
        """max |got - want| as a share of want's largest magnitude; raises
        above ``limit``."""
        assert got.shape == want.shape and bool(torch.isfinite(got).all()), name
        scale = float(want.abs().max())
        err = float((got - want).abs().max()) / scale
        if err > limit:
            raise RuntimeError(f"{name}: {err:.3e} of the scale {scale:.3e} off")
        return err

    # ---- 2. goldens through the facade ----------------------------------
    # the scenes of tests/test_goldens.py, rebuilt with numpy
    def golden_vols(n=18):
        z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
        c = (n - 1) / 2.0
        r2 = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) / c
        em = np.exp(-6.0 * (r2 - 0.55) ** 2).astype(np.float32)
        structure = (np.exp(-8.0 * ((x - c) / c) ** 2)
                     * np.exp(-4.0 * (r2 - 0.3) ** 2)).astype(np.float32)
        return em, structure

    def golden_base(em):
        r = VolumeRenderer()
        r.volume_emission = Volume.create(em)
        r.volume_absorption = Volume.create(em * 0.8)
        r.focal_length, r.distance_to_object = 3.0, 6.0
        r.rotate(125, 25, 0)
        r.image_resolution = (24, 20)
        return r

    def golden_render(name):
        em, structure = golden_vols()
        r = golden_base(em)
        if name in ("example1_otf", "example1_grad"):
            r.volume_reflection = Volume.create(em)
            r.volume_illumination = henyey_greenstein_lut(16)
            r.light_sources = [LightSource([5, 8, -4], [1.0, 0.7, 0.4])]
        if name == "example1_grad":
            r.volume_gradient_x, r.volume_gradient_y, r.volume_gradient_z = (
                Volume.create(em).gradient_volumes())
            r.factor_emission, r.factor_absorption, r.factor_reflection = 1.2, 0.7, 0.5
        if name == "example3_two_channel":
            r.color = (1.0, 0.3, 1.0)
            r2 = golden_base(structure)
            r2.color = (0.3, 1.0, 0.3)
            return r.render() + r2.render()
        if name == "example2_stereo":
            r.camera_x_offset = 0.25
            r.stereo_output = StereoRenderMode.RED_CYAN
        img = r.render()
        assert r.last_plan.path == kernel_path
        return img

    golden_err = {}
    for name in ("pr1_plain", "example1_otf", "example1_grad", "example3_two_channel",
                 "example2_stereo"):
        golden = torch.from_numpy(np.load(os.path.join(REPO, "tests", "goldens", f"{name}.npy")))
        # the goldens came from the JAX Pallas kernel (closed-form sample
        # positions); the port accumulates positions as the plain path does
        golden_err[name] = check(f"golden {name}", golden_render(name), golden, 1e-4, 1e-3, None)
    record({"phase": "goldens", "atol": 1e-4, "rtol": 1e-3, "max_abs_err": golden_err})

    # ---- 3. kernel vs plain at 24^3 / 256x192 ---------------------------
    compare = {}
    for name, mode, kw, offset in (
            ("K1_absorption_aliased", "K1", dict(ab_aliased=True), 0.0),
            ("K1_absorption_separate", "K1", dict(ab_aliased=False), 0.0),
            ("K1_absorption_other_shape", "K1", dict(ab_aliased=False, ab_other_shape=True), 0.0),
            ("K4_two_lights", "K4", dict(n_lights=2, ab_aliased=False), 0.0),
            ("K5_lookup", "K5", dict(), 0.0),
            ("K5_absorption_separate_reflection_aliased", "K5",
             dict(ab_aliased=False, re_aliased=True), 0.0),
            ("K5_absorption_other_shape", "K5", dict(ab_aliased=False, ab_other_shape=True), 0.0),
            ("K5_gradients_other_shape", "K5", dict(ab_aliased=False, grad_other_shape=True),
             0.0),
            ("K4_stereo_offset_0.25", "K4", dict(re_aliased=True), 0.25),
            ("K4_anisotropic_36x24x64", "K4", ANISOTROPIC, 0.0),
            ("K4_faces_and_edges_48", "K4", FACES, 0.0)):
        scene = flagship(48 if kw is FACES else PLAIN["volume"], mode, **kw)
        assert kernel_mode(scene) == mode
        if mode == "K5":  # packed unless the gradient volumes have another shape
            assert (cuda_march.pack_lookup(scene) is None) == ("grad_other_shape" in kw), name
        opts = scene.options(PLAIN["width"], PLAIN["height"])
        got = render_forward_fast(scene, opts, offset)
        torch.cuda.synchronize()
        compare[name] = check(f"kernel vs plain {name}", got, render_forward(scene, opts, offset),
                              *tol[mode], mode)
    record({"phase": "kernel_vs_plain", "volume": PLAIN["volume"],
            "image": [PLAIN["width"], PLAIN["height"]],
            "tolerance": {k: {"atol": a, "rtol": r} for k, (a, r) in tol.items()},
            "K1_K4_exact": True, "K5_packed_except": ["K5_gradients_other_shape"],
            "max_abs_err": compare})

    # ---- 4. backward kernel vs plain replay at 24^3 / 256x192 -----------
    # Kernel and plain replay compute each sample's terms with the same
    # float32 arithmetic and differ in the order of their sums: the kernel's
    # atomic adds land in no fixed order, index_add_ and torch.sum have their
    # own. The tolerance is a share of each gradient's largest magnitude.
    # Measured on an H100 at most 1.4e-5 (factor_emission of a lit scene: a
    # scalar whose per-ray terms cancel under a cotangent of mixed sign);
    # typically 3e-7.
    GRAD_TOL = 1e-4
    # The grids that the corner carry scatters (K3's, the K7 gradient
    # segment's against its plain pass, the bricked first step's against the
    # single-device kernels) are held tighter, so that an atomic add that
    # the carry loses or misplaces shows. Measured on an H100 at most
    # 1.9e-6. K3's parameter keys are sums of its per-ray planes, not of the
    # carry, and cancel under a cotangent of mixed sign as the lit scalar
    # does (1.2e-5 of factor_emission's scale with absorption of another
    # shape): they keep GRAD_TOL.
    BRICK_GRAD_TOL = 1e-5
    GRAD_TOLS = {"K3 grids": BRICK_GRAD_TOL, "others": GRAD_TOL}
    grad_err = {"K2": 0.0, "K3": 0.0, "K6": 0.0, "K2L": 0.0, "K6L": 0.0}  # share of the scale
    grad_abs_err = dict(grad_err)
    # the grids of every gradient: held at BRICK_GRAD_TOL where summed in another order
    GRID_NAMES = ("emission", "absorption", "reflection", "gradient_x", "gradient_y",
                  "gradient_z")

    def check_grads(name, got, want, mode, keys=None):
        """Every key of ``got`` against ``want``; returns the errors by key."""
        if keys is not None:
            assert set(got) == set(keys), (name, sorted(got), sorted(keys))
        errs = {}
        for key, value in got.items():
            a, b = value.double(), want[key].double()
            assert a.shape == b.shape, (name, key, a.shape, b.shape)
            if not bool(torch.isfinite(a).all()):
                raise RuntimeError(f"{name} {key}: non-finite values")
            scale = max(float(b.abs().max()), 1e-30)
            abs_err = float((a - b).abs().max())
            errs[key] = abs_err / scale
            if mode is not None:
                grad_err[mode] = max(grad_err[mode], errs[key])
                grad_abs_err[mode] = max(grad_abs_err[mode], abs_err)
                carried = mode == "K3" and key in ("emission", "absorption")
                if errs[key] > (BRICK_GRAD_TOL if carried else GRAD_TOL):
                    raise RuntimeError(f"{name} {key}: kernel and plain replay differ by "
                                       f"{errs[key]:.3e} of the gradient's scale {scale:.3e}")
        return errs

    def dp_grads_check(name, got, want):
        """Every key of ``got`` against ``want``: the grids (atomic adds in
        another order or split over launches) within 1e-5 of scale, the
        other keys GRAD_TOL."""
        errs = check_grads(name, got, want, None, keys=want.keys())
        for key, err in errs.items():
            limit = BRICK_GRAD_TOL if key in GRID_NAMES else GRAD_TOL
            if err > limit:
                raise RuntimeError(f"{name} {key}: the gradient is {err:.3e} of its scale off")
        return errs

    transfer_keys = ("factor_emission", "factor_absorption", "factor_reflection", "color",
                     "light_colors")
    # K6L and K2L (lit, lookup gradient volumes): K5's noisy scene packed with
    # absorption aliased, separate with reflection aliased and two lights,
    # unpacked with gradient volumes of another shape, with absorption and
    # reflection separate and of emission's shape (K6L's float2 accumulator,
    # K2L's paired form) and with reflection of another shape (K2L's unpaired
    # form); every key, the three gradient volumes' grids included, within
    # GRAD_TOL, and the form of each K2L launch from the launch counts
    grads_compare = {}
    for name, mode, kw, offset, reuse in (
            ("K3_absorption_aliased", "K1", dict(ab_aliased=True), 0.0, False),
            ("K3_absorption_separate_stereo_0.25_image_reuse", "K1", dict(ab_aliased=False),
             0.25, True),
            ("K3_absorption_other_shape", "K1", dict(ab_aliased=False, ab_other_shape=True), 0.0,
             False),
            ("K6_one_light_reflection_separate", "K4", dict(ab_aliased=False), 0.0, False),
            ("K6_two_lights_reflection_aliased_image_reuse", "K4",
             dict(n_lights=2, re_aliased=True), 0.0, True),
            ("K6_anisotropic_36x24x64", "K4", ANISOTROPIC, 0.0, False),
            ("K6_faces_and_edges_48", "K4", FACES, 0.0, False),
            ("K2_absorption_separate_paired", "K1", dict(ab_aliased=False), 0.0, False),
            ("K6L_packed_absorption_aliased", "K5", dict(ab_aliased=True), 0.0, False),
            ("K6L_packed_two_lights_reflection_aliased_image_reuse", "K5",
             dict(ab_aliased=False, re_aliased=True, n_lights=2), 0.0, True),
            ("K6L_gradients_other_shape", "K5", dict(ab_aliased=False, grad_other_shape=True),
             0.0, False),
            ("K2L_paired_absorption_reflection_separate", "K5", dict(ab_aliased=False), 0.0,
             False),
            ("K2L_unpaired_reflection_other_shape", "K5",
             dict(ab_aliased=False, re_other_shape=True), 0.0, False)):
        scene = flagship(48 if kw is FACES else PLAIN["volume"], mode,
                         **{"noise": 0.05, **kw})
        # unlit K2 reads the packed pair where absorption is separate and of
        # emission's shape
        paired = mode == "K1" and cuda_grads.pack_pair(scene) is not None
        if mode == "K1" and paired != (not kw["ab_aliased"] and "ab_other_shape" not in kw):
            raise RuntimeError(f"{name}: K2's pair {'packed' if paired else 'not packed'}")
        opts = scene.options(PLAIN["width"], PLAIN["height"])
        g = cotangent(PLAIN["height"], PLAIN["width"], seed=len(grads_compare))
        img0 = render_forward_fast(scene, opts, offset) if reuse else None
        img, got = voxel_grads_fast(scene, opts, g, offset, image=img0)
        forms_before = dict(cuda_march.LAUNCHES_BY_FORM)
        _, got_transfer = transfer_grads_fast(scene, opts, g, offset, image=img)
        k2_forms = {k: n - forms_before.get(k, 0) for k, n in cuda_march.LAUNCHES_BY_FORM.items()
                    if n != forms_before.get(k, 0)}
        if mode == "K5":
            # paired where absorption and reflection are separate and of
            # emission's shape beside the pack; never the plain version
            form = ("unpacked" if "grad_other_shape" in kw else "unpaired"
                    if kw["ab_aliased"] or "re_aliased" in kw or "re_other_shape" in kw
                    else "paired")
            if k2_forms != {f"K2L {form}": 1} or cuda_grads.k2l_form(scene) != form:
                raise RuntimeError(f"{name}: K2L launched {k2_forms}, not its {form} form")
        torch.cuda.synchronize()
        assert img0 is None or img is img0
        want = replay_backward(scene, opts, g, img, offset, angle_floor=True)
        bmode, pmode = grad_mode(scene, scatter=True), grad_mode(scene, scatter=False)
        if mode == "K5" and (cuda_march.pack_lookup(scene) is None) != ("grad_other_shape" in kw):
            raise RuntimeError(f"{name}: K6L's pack made where it should not be, or not made")
        grads_compare[name] = {
            "mode": bmode, "K2_paired": paired, "K2_launches_by_form": k2_forms,
            "err_of_scale": check_grads(name, got, want, bmode, keys=want.keys()),
            "K2_err_of_scale": check_grads(name + " K2", got_transfer, want, pmode,
                                           keys=[k for k in want if k in transfer_keys])}
        del scene, got, want
    record({"phase": "grads_vs_plain", "volume": PLAIN["volume"],
            "image": [PLAIN["width"], PLAIN["height"]], "volume_noise": 0.05,
            "tolerance_of_scale": GRAD_TOLS, "max_err_of_scale": dict(grad_err),
            "cases": grads_compare})

    # ---- 5. the main path: VolumeRenderer.render() at 256^3 / 512^2 -----
    def facade(mode):
        em = shell(MAIN["volume"]).cpu().numpy()
        r = VolumeRenderer()
        r.volume_emission = Volume.create(em)
        r.volume_absorption = Volume.create(em)
        r.factor_absorption, r.factor_reflection, r.color = 0.6, 0.4, (1.0, 0.9, 0.8)
        r.focal_length, r.distance_to_object = 3.0, 6.0
        r.rotate(125, 25, 0)
        r.image_resolution = (MAIN["image"], MAIN["image"])
        if mode != "K1":
            r.volume_reflection = Volume.create(em)
            r.volume_illumination = henyey_greenstein_lut(32)
            r.light_sources = [LightSource([2.0, 3.0, -1.5], [1.0, 1.0, 1.0])]
        if mode == "K5":
            r.volume_gradient_x, r.volume_gradient_y, r.volume_gradient_z = (
                Volume.create(em).gradient_volumes())
        return r

    renderers = {mode: facade(mode) for mode in ("K1", "K4", "K5")}
    for r in renderers.values():  # content hashes for the dedup, outside the window
        r._build_scene()
    torch.cuda.synchronize()
    cuda_march.reset_launch_counts()
    images = {mode: r.render() for mode, r in renderers.items()}
    torch.cuda.synchronize()
    launches = dict(cuda_march.LAUNCHES_BY_MODE)
    main = {"launches": launches, "total_launches": sum(launches.values())}
    for mode, img in images.items():
        if launches[mode] < 1:
            raise RuntimeError(f"the main path launched no {mode} kernel: {launches}")
        assert renderers[mode].last_plan.path == kernel_path
        scene = renderers[mode]._build_scene()
        opts = scene.options(MAIN["image"], MAIN["image"])
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        plain = render_forward(scene, opts)
        end.record()
        end.synchronize()
        main[mode] = {"max_abs_err": check(f"main path {mode}", img, plain, *tol[mode], mode),
                      "plain_ms": start.elapsed_time(end),
                      "nonzero_frac": float((img.amax(-1) > 0).float().mean()),
                      "finite": bool(torch.isfinite(img).all())}
    record({"phase": "main_path", "entry": "VolumeRenderer.render", "volume": MAIN["volume"],
            "image": MAIN["image"], **main})

    # ---- 6. the training main path at 256^3 / 512^2 ---------------------
    size = MAIN["image"]

    def band_check(name, scene, opts, g, img, scatter, also_k2=False, band=BAND):
        """The kernel on the whole image, with g zero outside a band of
        ``band`` rows through the middle, against the plain replay of that
        band alone. ``also_k2``: K2 (K2L) too, against the same replay (the
        plain version of every backward mode), under the key "K2"."""
        band0 = (opts.height - band) // 2
        g_band = torch.zeros_like(g)
        g_band[band0:band0 + band] = g[band0:band0 + band]
        entry = voxel_grads_fast if scatter else transfer_grads_fast
        _, got = entry(scene, opts, g_band, image=img)
        got_k2 = transfer_grads_fast(scene, opts, g_band, image=img)[1] if also_k2 else None
        cut = slice(band0, band0 + band)
        # K3 and K6 also over the band alone, as rays-DP launches them
        got_alone = voxel_grads_fast(scene, opts, g[cut].contiguous(), image=img[cut].contiguous(),
                                     y_offset=band0, n_rows=band)[1] if scatter else None
        torch.cuda.synchronize()
        want, plain_ms = timed(lambda: replay_backward(
            scene, opts, g[cut].contiguous(), img[cut].contiguous(),
            y_offset=band0, n_rows=band, angle_floor=True))
        mode = grad_mode(scene, scatter)
        out = {"mode": mode, "band_rows": band, "band_first_row": band0, "plain_ms": plain_ms,
               "err_of_scale": check_grads(name, got, want, mode)}
        if scatter:
            out["band_alone_err_of_scale"] = check_grads(name + " band alone", got_alone, want,
                                                         mode)
        if also_k2:
            k2 = grad_mode(scene, scatter=False)
            out["K2"] = {"mode": k2, "band_rows": band, "plain_ms": plain_ms,
                         "err_of_scale": check_grads(name + " " + k2, got_k2, want, k2)}
        return out

    train_scenes = {"K3": flagship(MAIN["volume"], "K1", ab_aliased=False, noise=0.05),
                    "K6": flagship(MAIN["volume"], "K4", ab_aliased=False, noise=0.05),
                    "K6L": flagship(MAIN["volume"], "K5", ab_aliased=False, noise=0.05)}
    runs, first_step = {}, {}
    for mode, scene in train_scenes.items():
        opts = scene.options(size, size)
        target = render_forward_fast(scene, opts)
        params, static_scene = train.split_params(scene)
        with torch.no_grad():
            params["emission"].mul_(1.3).add_(0.05)
        optimizer = torch.optim.Adam(list(params.values()), lr=TRAIN_LR[mode])
        merged = train.merge_params(params, static_scene)
        img = render_forward_fast(merged, opts)
        first_step[mode] = band_check(f"first step {mode}", merged, opts, 2.0 * (img - target),
                                      img, scatter=True, also_k2=True)
        runs[mode] = (lambda p=params, o=optimizer, sc=static_scene, op=opts, t=target:
                      train.train_step_fast(p, o, sc, op, t))
    # the transfer fit: the unlit scene's factors and color, the grids fixed;
    # unlit K2 held against the replay of K3's first-step band above
    first_step["K2"] = first_step["K3"].pop("K2")
    scene = train_scenes["K3"]
    opts = scene.options(size, size)
    tparams, toptimizer, target = transfer_fit(scene, opts)
    runs["K2"] = lambda: transfer_step(tparams, toptimizer, scene, opts, target)
    # lit K2 against the replay of the lit first step's band (phase 7 times it)
    first_step["K2_lit"] = first_step["K6"].pop("K2")
    # the lookup transfer fit (K5 + K2L): K2L held against the replay of
    # K6L's first-step band above
    first_step["K2L"] = first_step["K6L"].pop("K2")
    lscene = train_scenes["K6L"]
    lparams, loptimizer, ltarget = transfer_fit(lscene, opts)
    runs["K2L"] = lambda: transfer_step(lparams, loptimizer, lscene, opts, ltarget)
    del merged, img

    torch.cuda.synchronize()
    cuda_march.reset_launch_counts()
    losses = {mode: [float(step()) for _ in range(TRAIN_STEPS)] for mode, step in runs.items()}
    torch.cuda.synchronize()
    train_launches = dict(cuda_march.LAUNCHES_BY_MODE)
    train_forms = dict(cuda_march.LAUNCHES_BY_FORM)
    # the lookup fit's scene has absorption and reflection of emission's
    # shape: every K2L launch is the paired form
    if train_forms != {"K2L paired": train_launches["K2L"]}:
        raise RuntimeError(f"the lookup fit launched K2L's forms {train_forms}, "
                           f"not {train_launches['K2L']} paired ones")
    for mode, values in losses.items():
        if train_launches[mode] < TRAIN_STEPS:
            raise RuntimeError(f"the training path launched {mode} {train_launches[mode]} times")
        if not (all(np.isfinite(values)) and all(b < a for a, b in zip(values, values[1:]))):
            raise RuntimeError(f"the {mode} loss did not fall: {values}")
    if (train_launches["K1"] < 2 * TRAIN_STEPS or train_launches["K4"] < TRAIN_STEPS
            or train_launches["K5"] < 2 * TRAIN_STEPS):
        raise RuntimeError(f"the training path skipped a forward kernel: {train_launches}")
    record({"phase": "train_main_path",
            "entry": {"K3": "train.train_step_fast (unlit)", "K6": "train.train_step_fast (lit)",
                      "K2": "transfer_grads_fast fit",
                      "K6L": "train.train_step_fast (lit, lookup gradient volumes)",
                      "K2L": "transfer_grads_fast fit (lit, lookup gradient volumes)"},
            "volume": MAIN["volume"], "image": size, "steps": TRAIN_STEPS, "optimizer": "Adam",
            "lr": TRAIN_LR, "volume_noise": 0.05,
            "launches": train_launches, "launches_by_form": train_forms, "losses": losses,
            "first_step_vs_plain_band": first_step,
            "tolerance_of_scale": GRAD_TOLS})
    del runs, train_scenes, params, optimizer, static_scene, target, tparams, toptimizer
    del lscene, lparams, loptimizer, ltarget
    torch.cuda.empty_cache()

    # ---- 7. timing at 256^3 / 512^2 and 512^3 / 1024^2 -------------------
    def volume_bytes(scene, mode):
        vols = [scene.emission.data]
        if not scene.absorption_aliased:
            vols.append(scene.absorption.data)
        if mode != "K1":
            vols.append(scene.illumination)
            if not scene.reflection_aliased:
                vols.append(scene.reflection.data)
            if mode == "K5":
                vols += [scene.gradient_x.data, scene.gradient_y.data, scene.gradient_z.data]
        # the operation counts fetch every volume but the LUT at the emission's corners
        assert all(v.shape == vols[0].shape for v in vols if v is not scene.illumination)
        return sum(v.numel() * 4 for v in vols)

    def time_cell(scene, size, band_rows=None, reps=5, held=None):
        """The forward kernel's ms (CUDA events, median of ``reps``), its
        samples and bound, the kernel over a band alone against the same
        rows; the plain version on ``band_rows`` rows through the middle
        (None: the whole image) against the kernel's image. ``held``
        ({"plain_ms", "max_abs_err", "plain_cell"}): where this mode at this
        size was already held against the plain version (phase 5 holds the
        facade's image on the whole image; ``plain_ms`` None where no plain
        version runs at this size), reported instead of marching the plain
        version again; the band alone is then held against the whole
        launch's rows to the bit."""
        mode = kernel_mode(scene)
        opts = scene.options(size, size)
        steps = torch.zeros((size, size), dtype=torch.int32, device=dev)
        img = render_forward_fast(scene, opts, steps=steps)  # warm-up, and the step counts
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            render_forward_fast(scene, opts)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = float(np.median(times))
        y0 = 0 if band_rows is None else (size - band_rows) // 2
        rows = size if band_rows is None else band_rows
        # the kernel over a band alone, as rays-DP launches it
        by0, brows = (y0, rows) if band_rows else (3 * size // 4, BAND)
        band = render_rows_fast(scene, opts, 0.0, by0, brows)
        if held is None:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            plain = render_rows(scene, opts, 0.0, y0, rows)
            end.record()
            end.synchronize()
            held = {"plain_ms": start.elapsed_time(end),
                    "max_abs_err": check(f"timing cell {mode} {size}", img[y0:y0 + rows], plain,
                                         *tol[mode], mode),
                    "plain_cell": f"{rows} rows from {y0}"}
            band_err = check(f"timing cell {mode} {size} band alone", band,
                             plain[by0 - y0:by0 - y0 + brows], *tol[mode], mode)
        else:  # against the same rows of the whole launch
            if not torch.equal(band, img[by0:by0 + brows]):
                raise RuntimeError(f"timing cell {mode} {size}: the band alone differs from "
                                   "the whole launch's rows")
            band_err = 0.0
        samples = int(steps.sum())
        n_lights = 0 if mode == "K1" else scene.light_positions.shape[0]
        flops = samples * flops_per_step(mode, scene.absorption_aliased,
                                         scene.reflection_aliased, n_lights)
        nbytes = volume_bytes(scene, mode) + size * size * 3 * 4
        bound = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3, "operations": flops / PEAK_FP32_FLOPS * 1e3}
        bound_by = max(bound, key=bound.get)
        extra = {}
        if mode == "K5":
            # the pack alone (the forward's ms includes it), beside the same
            # copy as one torch.stack(..., dim=-1); and the gather model of
            # its float4 corner loads against float32 ones on a band of 64
            # rows through the middle, 16x2 warps
            packed = cuda_march.pack_lookup(scene)
            vols = [v.data for v in (scene.emission, scene.gradient_x, scene.gradient_y,
                                     scene.gradient_z)]
            if not torch.equal(packed, torch.stack(vols, dim=-1)):
                raise RuntimeError("the K5 pack is not its four volumes side by side")
            del packed
            extra["pack_ms"] = median_ms(lambda: cuda_march.pack_lookup(scene))[0]
            extra["pack_stack_last_ms"] = median_ms(lambda: torch.stack(vols, dim=-1))[0]
            if size == MAIN["image"]:
                extra["gather_model"] = gather_footprint(scene, opts, (size - 64) // 2, 64,
                                                         warp_cols=(16,), elems=(4, 16))
        return {**extra, "mode": mode, "image": size, "ms": ms, "ms_all": times,
                "rays_per_s": size * size / (ms * 1e-3), "samples": samples,
                "samples_per_ray": samples / (size * size), "flops": flops, "bytes": nbytes,
                "bound_ms": bound[bound_by], "bound_by": bound_by, "plain_rows": rows, **held,
                "band_alone": {"first_row": by0, "rows": brows, "max_abs_err": band_err},
                "finite": bool(torch.isfinite(img).all()),
                "nonzero_frac": float((img.amax(-1) > 0).float().mean())}

    # The plain version at 256^3 / 512^2 ran in phase 5, on the whole image
    # of each mode's facade scene (the instantiation timed here: absorption
    # and reflection separate, one light); it is not marched again. At
    # 512^3 / 1024^2 K1 and K5 are held on a band; K4 is not (its volumes
    # are K1's, indexed by the same code; its plain band cost 50-67 s).
    held = {(MAIN["volume"], mode): {"plain_ms": main[mode]["plain_ms"],
                                     "max_abs_err": main[mode]["max_abs_err"],
                                     "plain_cell": "phase 5: the facade's scene, whole image"}
            for mode in ("K1", "K4", "K5")}
    held[BIG["volume"], "K4"] = {"plain_ms": None, "max_abs_err": None,
                                 "plain_cell": "not run at this size (K4 held at 256^3)"}
    cells = {}
    for cfg, modes, band in ((MAIN, ("K1", "K4", "K5"), None),
                             (BIG, ("K1", "K4", "K5"), BIG["band"])):
        for mode in modes:
            key = f"{mode}_{cfg['volume']}_{cfg['image']}"
            scene = flagship(cfg["volume"], mode, ab_aliased=False)
            cells[key] = time_cell(scene, cfg["image"], band_rows=band,
                                   held=held.get((cfg["volume"], mode)))
            record({"phase": "timing", "cell": key, "volume": cfg["volume"], **cells[key]})
            del scene
            if DEVICE == "cuda":
                torch.cuda.empty_cache()

    # ---- forward + backward at 256^3 / 512^2 and 512^3 / 1024^2 ---------
    def time_train_cell(scene, size, scatter, plain=None, band=True, rows=BAND):
        """The first training step's state (emission x 1.3 + 0.05 against a
        target of the true scene): the backward kernel alone, the forward +
        backward pair and the whole training step: train_step_fast with
        grids, a transfer-fit step (transfer_fit) without. ``plain``: the
        band's check against the plain replay, made here if None and
        ``band``. Unlit K2 also times its pack alone and, at 256^3 / 512^2,
        counts the gather model (gather_footprint) of its float2 corner
        loads against float32 ones on a band of 64 rows; K2L likewise its
        pair (and K5's pack, and the kernel without either) and the tail
        factor of its blocks."""
        mode, fmode = grad_mode(scene, scatter), kernel_mode(scene)
        lit, lookup = scene.has_lighting, fmode == "K5"
        opts = scene.options(size, size)
        entry = voxel_grads_fast if scatter else transfer_grads_fast
        with torch.no_grad():
            target = render_forward_fast(scene, opts)
            params, static_scene = train.split_params(scene)
            params["emission"].mul_(1.3).add_(0.05)
            merged = train.merge_params(params, static_scene)
            steps = torch.zeros((size, size), dtype=torch.int32, device=dev)
            img = render_forward_fast(merged, opts, steps=steps)
            g = 2.0 * (img - target)
            if plain is None and band:
                plain = band_check(f"timing cell {mode} {size}", merged, opts, g, img, scatter,
                                   band=rows)
            extra = {}
            pair = cuda_grads.pack_pair(merged) if mode == "K2" and not lit else None
            if pair is not None:
                vols = [merged.emission.data, merged.absorption.data]
                if not torch.equal(pair, torch.stack(vols, dim=-1)):
                    raise RuntimeError("the K2 pack is not its two volumes side by side")
                del pair
                extra["pack_ms"] = median_ms(lambda: cuda_grads.pack_pair(merged))[0]
                if size == MAIN["image"]:
                    extra["gather_model"] = gather_footprint(
                        merged, opts, (size - 64) // 2, 64, warp_cols=(16,), elems=(4, 8))
            adds = None
            if mode == "K3" and size == MAIN["image"]:
                # the corner carry's atomic adds, from the plain march (march_flushes)
                n, flushes = march_flushes(merged, opts)
                adds = {"samples": n, "flushes": flushes,
                        "atomic_adds_per_sample": sum(flushes.values()) / n,
                        "atomic_adds_per_sample_uncarried": 8 * len(flushes)}
            if mode == "K6L" and size == MAIN["image"]:
                # the reductions at every sample's corners: K5's samples at
                # the plain march's positions (march_scatter_adds); and the
                # unpack of the accumulators into the grids alone (the
                # backward's ms includes it)
                adds = {**march_scatter_adds(merged, opts, steps),
                        "packed": cuda_march.pack_lookup(merged) is not None}
                accs, grids = cuda_grads.zero_accumulators(merged), cuda_grads.zero_grids(merged)
                extra["unpack_ms"] = median_ms(
                    lambda: [cuda_grads.unpack_accumulator(a, grids) for a in accs])[0]
                del accs, grids
            if mode == "K2L":
                # K2L alone, K5's pack and the pair made outside the timed
                # call (the call's ms includes both); each pack alone; the
                # gather model of the pair's float2 corner loads against
                # float32 ones on a band of 64 rows; the tails of K2L's
                # blocks from K5's steps plane, whose samples it replays
                packed = cuda_march.pack_lookup(merged)
                lpair = cuda_grads.pack_lookup_pair(merged)
                vols = [merged.absorption.data, merged.reflection.data]
                if lpair is None or not torch.equal(lpair, torch.stack(vols, dim=-1)):
                    raise RuntimeError("the K2L pair is not absorption and reflection side by side")
                forms_before = dict(cuda_march.LAUNCHES_BY_FORM)
                extra["kernel_ms"], extra["kernel_ms_all"] = median_ms(lambda: march_backward(
                    merged, opts, g, img, scatter=False, packed=packed, pair=lpair))
                extra["launches_by_form"] = {
                    k: n - forms_before.get(k, 0) for k, n in cuda_march.LAUNCHES_BY_FORM.items()
                    if n != forms_before.get(k, 0)}
                if set(extra["launches_by_form"]) != {"K2L paired"}:
                    raise RuntimeError(f"K2L alone launched {extra['launches_by_form']}")
                del packed, lpair
                extra["pack_ms"] = median_ms(lambda: cuda_march.pack_lookup(merged))[0]
                extra["pair_pack_ms"] = median_ms(lambda: cuda_grads.pack_lookup_pair(merged))[0]
                extra["gather_model"] = gather_footprint(
                    merged, opts, (size - 64) // 2, 64, warp_cols=(16,), elems=(4, 8))
                k2l_rows = threads["march_bwd_lookup_params_kernel"] // 16
                extra["block"] = [16, k2l_rows]
                extra["tail_factor"] = tail_factor(steps, 16, k2l_rows)
                extra["tail_factors"] = tail_factors(steps)
            bwd_ms, bwd_all = median_ms(
                lambda: march_backward(merged, opts, g, img, scatter=scatter))

            def fwd_bwd():
                image = render_forward_fast(merged, opts)
                return entry(merged, opts, 2.0 * (image - target), image=image)

            pair_ms, pair_all = median_ms(fwd_bwd)
        out = {**extra, "mode": mode, "forward_mode": fmode, "image": size, "ms": bwd_ms,
               "ms_all": bwd_all, "fwd_bwd_ms": pair_ms, "fwd_bwd_ms_all": pair_all}
        if adds is not None:
            out["atomic_adds"] = adds
        if scatter:
            optimizer = torch.optim.Adam(list(params.values()), lr=TRAIN_LR[mode])
            out["train_step_ms"], out["train_step_ms_all"] = median_ms(
                lambda: train.train_step_fast(params, optimizer, static_scene, opts, target))
        else:
            tparams, toptimizer, ttarget = transfer_fit(scene, opts)
            out["train_step_ms"], out["train_step_ms_all"] = median_ms(
                lambda: transfer_step(tparams, toptimizer, scene, opts, ttarget))
        n_lights = scene.light_positions.shape[0] if lit else 0
        samples = int(steps.sum())
        flops = samples * bwd_flops_per_step(lit, scatter, scene.absorption_aliased,
                                             scene.reflection_aliased, n_lights, lookup=lookup)
        # each volume read once, each gradient grid written once, g and the
        # image read once, the per-ray planes written once
        grids = 0
        if scatter:
            grids = scene.emission.data.numel() * 4 * (
                1 + (not scene.absorption_aliased) + (lit and not scene.reflection_aliased)
                + 3 * lookup)
        nbytes = (volume_bytes(scene, fmode) + grids + 2 * size * size * 3 * 4
                  + (3 + 3 * n_lights) * size * size * 4)
        bound = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3,
                 "operations": flops / PEAK_FP32_FLOPS * 1e3}
        bound_by = max(bound, key=bound.get)
        out.update({"samples": samples, "samples_per_ray": samples / (size * size),
                    "flops": flops, "bytes": nbytes, "bound_ms": bound[bound_by],
                    "bound_by": bound_by})
        if plain is not None:
            out.update({"plain_ms": plain["plain_ms"], "plain_rows": plain["band_rows"],
                        "plain_err_of_scale": plain["err_of_scale"]})
        return out

    # K2 at 512^3 / 1024^2: the kernel and its pack, no plain band (the run's time)
    # K6L and K2L on K5's noisy scene, their bands held in phase 6 (64 rows)
    fwd_of = {"K6": "K4", "K2_lit": "K4", "K6L": "K5", "K2L": "K5"}
    for cfg, modes in ((MAIN, ("K3", "K6", "K2", "K2_lit", "K6L", "K2L")), (BIG, ("K3", "K2"))):
        for mode in modes:
            key = f"{mode}_{cfg['volume']}_{cfg['image']}"
            scene = flagship(cfg["volume"], fwd_of.get(mode, "K1"), ab_aliased=False, noise=0.05)
            # at 256^3 the band was held against the plain replay in phase 6
            plain = first_step[mode] if cfg is MAIN else None
            cells[key] = time_train_cell(scene, cfg["image"],
                                         scatter=mode in ("K3", "K6", "K6L"),
                                         plain=plain, band=mode != "K2",
                                         rows=BIG["band"] if cfg is BIG else BAND)
            record({"phase": "timing", "cell": key, "volume": cfg["volume"], **cells[key]})
            del scene
            torch.cuda.empty_cache()


    # ---- 8. the z-brick kernels vs their plain passes at 24^3 / 256x192 ---
    K7_FORMS = ("transmittance", "segment", "scatter")
    brick_err = {form: 0.0 for form in K7_FORMS}  # max abs error against the plain pass
    brick_grad_err = [0.0]                        # share of the gradient's scale

    def image_tolerance(name, got, want):
        """A bricked image against the single-device kernel's. The entry
        opacity 1 - prod T equals the sequential recurrence only to
        rounding, so a ray that stops within an ulp of the threshold may
        take one sample more or less. A sample adds about alpha / threshold
        of its pixel, 5e-3 / 0.3 on the dense scene: allowed are 2e-2 of the
        image's largest value (measured 3.9e-3 there), on fewer than 1e-3 of
        the values; everywhere else 1e-5 of it."""
        assert got.shape == want.shape and bool(torch.isfinite(got).all()), name
        scale = float(want.abs().max())
        diff = (got - want).abs()
        err, off = float(diff.max()), float((diff > 1e-5 * scale).float().mean())
        if err > 2e-2 * scale or off > 1e-3:
            raise RuntimeError(f"{name}: bricked and single-device images differ by {err:.3e} "
                               f"(scale {scale:.3e}), {off:.2e} of the values beyond 1e-5")
        return {"max_abs_err": err, "scale": scale, "share_beyond_1e-5_of_scale": off}

    def bricks_compare(name, scene, opts, g, band=None, held=None):
        """Every K7 launch form on every brick ``held`` (indices; None: all),
        on the whole image, against its plain pass on the same inputs; the
        plain passes march the whole image or, with ``band``, that many rows
        through the middle (g is then zero outside them)."""
        y0, rows = (0, opts.height) if band is None else ((opts.height - band) // 2, band)
        if band is not None:
            g_band = torch.zeros_like(g)
            g_band[y0:y0 + rows] = g[y0:y0 + rows]
            g = g_band

        def cut(t):
            return t[y0:y0 + rows].contiguous()

        split = bricks.split_bricks(scene, make_mesh(BRICKS))
        fwd = bricks._forward(split, opts, 0.0, fast=True)
        up_dots = bricks._upstream([brick_march.own_dot(g, own) for own in fwd.own],
                                   fwd.ascending, torch.cumsum, 0.0)
        errs = {form: 0.0 for form in K7_FORMS}
        plain_ms = {form: 0.0 for form in K7_FORMS}
        got_grads, want_grads = [], []
        for brick, w_in, up in zip(split.bricks, fwd.w_in, up_dots):
            if held is not None and brick.index not in held:
                continue
            w_in, up = w_in.contiguous(), up.contiguous()
            w_own, entry = cuda_bricks.brick_transmittance(brick, opts)
            own, w_out = cuda_bricks.brick_segment(brick, opts, 0.0, w_in, entry)
            got_grads.append(cuda_bricks.brick_gradients(brick, opts, 0.0, g, fwd.image, w_in, up,
                                                         entry))
            torch.cuda.synchronize()
            band_kw = dict(y_offset=y0, n_rows=rows)
            (p_own, p_entry), ms = timed(lambda: brick_march.transmittance_pass(
                brick, opts, 0.0, **band_kw))
            plain_ms["transmittance"] += ms
            tag = f"{name} brick {brick.index}"
            # positions are stored, not recomputed: the records must be the bit
            band_entry = entry.rows(y0, rows)
            if not (torch.equal(band_entry.step, p_entry.step)
                    and torch.equal(band_entry.state, p_entry.state)):
                raise RuntimeError(f"{tag}: the kernel's entry record differs from the plain one")
            (p_contrib, p_out), ms = timed(lambda: brick_march.shaded_pass(
                brick, opts, 0.0, cut(w_in), entry=band_entry, **band_kw))
            plain_ms["segment"] += ms
            want, ms = timed(lambda: brick_march.replay_pass(
                brick, opts, 0.0, cut(g), cut(fwd.image), cut(w_in), cut(up), angle_floor=True,
                entry=band_entry, **band_kw))
            plain_ms["scatter"] += ms
            want_grads.append(want)
            errs["transmittance"] = max(errs["transmittance"], check(
                f"{tag} phase 1 opacity", cut(w_own), p_own, *tol["K1"], None))
            errs["segment"] = max(
                errs["segment"],
                check(f"{tag} phase 2 contribution", cut(own), p_contrib, *tol["K1"], None),
                check(f"{tag} phase 2 exit opacity", cut(w_out), p_out, *tol["K1"], None))
            # phases 1 and 2 repeat their plain passes' arithmetic in the same order
            if errs["transmittance"] or errs["segment"]:
                raise RuntimeError(f"{tag}: a brick forward phase is off its plain pass: {errs}")
        # the gradient segment: each key as a share of its largest magnitude
        # over the bricks (kernel and plain pass differ in the order of sums)
        grad_errs = {}
        for key in want_grads[0]:
            scale = max(max(float(w[key].abs().max()) for w in want_grads), 1e-30)
            for got, want in zip(got_grads, want_grads):
                assert got[key].shape == want[key].shape, (name, key)
                if not bool(torch.isfinite(got[key]).all()):
                    raise RuntimeError(f"{name} {key}: non-finite values")
                abs_err = float((got[key].double() - want[key].double()).abs().max())
                grad_errs[key] = max(grad_errs.get(key, 0.0), abs_err / scale)
                errs["scatter"] = max(errs["scatter"], abs_err)
            if grad_errs[key] > BRICK_GRAD_TOL:
                raise RuntimeError(f"{name} {key}: brick kernel and plain pass differ by "
                                   f"{grad_errs[key]:.3e} of the gradient's scale {scale:.3e}")
        assert set(got_grads[0]) == set(want_grads[0]), (name, sorted(got_grads[0]))
        for form in K7_FORMS:
            brick_err[form] = max(brick_err[form], errs[form])
        brick_grad_err[0] = max(brick_grad_err[0], max(grad_errs.values()))
        return {"ascending_share": float(fwd.ascending.float().mean()),
                "max_abs_err": errs, "entry_records_equal": True, "grad_err_of_scale": grad_errs,
                "plain_ms": plain_ms, "plain_rows": rows, "image": fwd.image,
                "plain_cell": (f"every brick of {BRICKS}" if held is None else
                               f"brick {', '.join(map(str, held))} of {BRICKS}")
                + f", {rows} rows"}

    bricks_cases = {}
    for i, (name, rot, kw) in enumerate((
            ("dz_positive", (10, 5, 0), {}),
            ("dz_negative_aliased", (180, 20, 0), dict(ab_aliased=True)),
            ("dz_mixed", (88, 0, 0), {}),
            ("dz_positive_absorption_other_shape", (10, 5, 0), dict(ab_other_shape=True)))):
        scene = brick_scene(PLAIN["volume"], rot, **kw)
        opts = scene.options(PLAIN["width"], PLAIN["height"])
        entry = bricks_compare(name, scene, opts,
                               cotangent(PLAIN["height"], PLAIN["width"], seed=10 + i),
                               band=BRICK_BAND)
        image = entry.pop("image")
        entry["vs_single_device_kernel"] = image_tolerance(
            name, image, render_forward_fast(scene, opts))
        entry["nonzero_frac"] = float((image.amax(-1) > 0).float().mean())
        bricks_cases[name] = entry
        del scene
    signs = [c["ascending_share"] for c in bricks_cases.values()][:3]
    if not (signs[0] == 1.0 and signs[1] == 0.0 and 0.05 < signs[2] < 0.95):
        raise RuntimeError(f"the cameras do not cover rising, falling and mixed rays: {signs}")

    # Lit scenes: the lit forms of phase 2 and of the gradient segment
    # against their plain passes on the same inputs, launched on the whole
    # image and compared on a band through the middle (the cotangent zero
    # outside it), at 32^3 / 96x64: the plain lit passes cost thousands of
    # launches a step whatever the rays. Lit phase 2 equals its plain pass to
    # the bit on the on-the-fly scene (K4's step) and within K5's tolerance
    # on the lookup ones (the packed window; gradient volumes of another
    # shape, unpacked, on the last brick); the lit gradient
    # segment's grids are held within 1e-5 of scale, its other keys within
    # GRAD_TOL. The bricked image and the slabbed sweep against the
    # single-device kernel.
    brick_err.update(segment_lit=0.0, scatter_lit=0.0, scatter_lookup=0.0)
    lit_plain_ms = {"segment_lit": 0.0, "scatter_lit": 0.0, "scatter_lookup": 0.0}

    def lit_bricks_compare(name, scene, opts, g, band, held=None, grad_held=None, grads=True):
        """The lit forms of the bricks ``held`` (indices; None: all) against
        their plain passes on ``band`` rows through the middle, the gradient
        segment (lookup: its lookup form) on the bricks ``grad_held`` (None:
        ``held``) unless not ``grads``; the record has the plain passes' ms.
        Lookup: the packed form of lit phase 2 (where the port packs the
        windows) also against the per-window form on the same inputs, to the
        bit."""
        lookup = scene.has_gradient_volumes
        scat = "scatter_lookup" if lookup else "scatter_lit"
        grad_held = held if grad_held is None else grad_held
        packed = lookup and cuda_bricks.pack_window(split_first(scene)) is not None
        y0, rows = (opts.height - band) // 2, band
        g_band = torch.zeros_like(g)
        g_band[y0:y0 + rows] = g[y0:y0 + rows]

        def cut(t):
            return t[y0:y0 + rows].contiguous()

        split = bricks.split_bricks(scene, make_mesh(BRICKS))
        fwd = bricks._forward(split, opts, 0.0, fast=True)
        up_dots = bricks._upstream([brick_march.own_dot(g_band, own) for own in fwd.own],
                                   fwd.ascending, torch.cumsum, 0.0)
        band_kw = dict(y_offset=y0, n_rows=rows)
        seg_err, got_grads, want_grads = 0.0, [], []
        plain_ms = {"segment_lit": 0.0, scat: 0.0}
        for brick, w_in, up, entry in zip(split.bricks, fwd.w_in, up_dots, fwd.entry):
            if held is not None and brick.index not in held:
                continue
            w_in, up = w_in.contiguous(), up.contiguous()
            own, w_out = cuda_bricks.brick_segment(brick, opts, 0.0, w_in, entry)
            if packed:  # the two instantiations fetch the same floats
                u_own, u_out = unpacked(lambda: cuda_bricks.brick_segment(brick, opts, 0.0, w_in,
                                                                          entry))
                if not (torch.equal(own, u_own) and torch.equal(w_out, u_out)):
                    raise RuntimeError(f"{name} brick {brick.index}: packed and unpacked lit "
                                       "phase 2 differ")
            band_entry = entry.rows(y0, rows)
            (p_own, p_out), ms = timed(lambda: brick_march.shaded_pass(
                brick, opts, 0.0, cut(w_in), entry=band_entry, **band_kw))
            plain_ms["segment_lit"] += ms
            tag = f"{name} brick {brick.index}"
            mode = "K5" if lookup else "K4"
            seg_err = max(seg_err,
                          check(f"{tag} lit phase 2 contribution", cut(own), p_own, *tol[mode],
                                None),
                          check(f"{tag} lit phase 2 exit opacity", cut(w_out), p_out, *tol[mode],
                                None))
            if not lookup and seg_err:
                raise RuntimeError(f"{tag}: lit phase 2 is {seg_err:.3e} off its plain pass")
            if not grads or (grad_held is not None and brick.index not in grad_held):
                continue
            got_grads.append(cuda_bricks.brick_gradients(brick, opts, 0.0, g_band, fwd.image,
                                                         w_in, up, entry))
            want, ms = timed(lambda: brick_march.replay_pass(
                brick, opts, 0.0, cut(g_band), cut(fwd.image), cut(w_in), cut(up),
                angle_floor=True, entry=band_entry, **band_kw))
            plain_ms[scat] += ms
            want_grads.append(want)
        brick_err["segment_lit"] = max(brick_err["segment_lit"], seg_err)
        grad_errs = {}
        for key in (want_grads[0] if want_grads else {}):
            scale = max(max(float(w[key].abs().max()) for w in want_grads), 1e-30)
            for got, want in zip(got_grads, want_grads):
                assert got[key].shape == want[key].shape, (name, key)
                abs_err = float((got[key].double() - want[key].double()).abs().max())
                grad_errs[key] = max(grad_errs.get(key, 0.0), abs_err / scale)
                brick_err[scat] = max(brick_err[scat], abs_err)
            limit = BRICK_GRAD_TOL if key in GRID_NAMES else GRAD_TOL
            if grad_errs[key] > limit:
                raise RuntimeError(f"{name} {key}: the lit gradient segment is "
                                   f"{grad_errs[key]:.3e} of its scale off its plain pass")
        if got_grads:
            assert set(got_grads[0]) == set(want_grads[0]), (name, sorted(got_grads[0]))
            brick_grad_err[0] = max(brick_grad_err[0], max(grad_errs.values()))
        single = render_forward_fast(scene, opts)
        slabbed = cuda_slab.render_forward_slabbed_fast(scene, opts, n_slabs=BRICKS)
        return {"ascending_share": float(fwd.ascending.float().mean()),
                "bricks_held": sorted(held) if held is not None else list(range(BRICKS)),
                "gradient_bricks_held": ([] if not grads else sorted(grad_held)
                                         if grad_held is not None else list(range(BRICKS))),
                **({"packed": packed, "packed_equals_unpacked": packed} if lookup else {}),
                "plain_ms": plain_ms, "plain_rows": rows,
                "phase_2_max_abs_err": seg_err, "grad_err_of_scale": grad_errs,
                "bricked_vs_single_device_kernel": image_tolerance(name, fwd.image, single),
                "slabbed_vs_single_device_kernel_of_scale": of_scale(
                    f"{name} slabbed", slabbed, single)}

    def unpacked(fn):
        """``fn()`` with lit phase 2's windows left unpacked
        (``cuda_bricks.pack_window`` giving None for the call), so that it
        launches the per-window form on the same grids."""
        pack = cuda_bricks.pack_window
        cuda_bricks.pack_window = lambda brick: None
        try:
            return fn()
        finally:
            cuda_bricks.pack_window = pack

    def split_first(scene):
        """Brick 0 of ``scene`` cut in BRICKS."""
        return bricks.split_bricks(scene, make_mesh(BRICKS)).bricks[0]

    lit_cases = {}
    lit_w, lit_h = LIT_BRICKS["width"], LIT_BRICKS["height"]
    for i, (name, mode, kw) in enumerate((
            ("otf_two_lights_dz_mixed", "K4",
             dict(ab_aliased=False, n_lights=2, noise=0.05, rotate=(88, 0, 0))),
            ("lookup_packed", "K5", dict(ab_aliased=False, noise=0.05)),
            ("lookup_gradients_other_shape", "K5",
             dict(ab_aliased=False, grad_other_shape=True, noise=0.05)))):
        scene = flagship(LIT_BRICKS["volume"], mode, **kw)
        if mode == "K5":  # packed unless the gradient volumes have another shape
            assert ((cuda_bricks.pack_window(split_first(scene)) is None)
                    == ("grad_other_shape" in kw)), name
        # the unpacked form on the last brick alone (its offsets are the
        # largest), and the lookup gradient segment there alone on both
        held = {BRICKS - 1} if "grad_other_shape" in kw else None
        lit_cases[name] = lit_bricks_compare(
            name, scene, scene.options(lit_w, lit_h), cotangent(lit_h, lit_w, seed=20 + i),
            LIT_BRICKS["band"], held, grad_held={BRICKS - 1} if mode == "K5" else None)
        for form, ms in lit_cases[name]["plain_ms"].items():
            lit_plain_ms[form] += ms
        del scene
    # Band launches (a rank of a rows x bricks mesh marches one): every K7
    # form over the two halves of the image, bands of BRICK_BAND rows, at
    # 24^3 / 256x192 on 4 bricks. Each band against the whole launch's rows
    # (phase 1's opacity and record, phase 2's contribution and exit opacity,
    # lit phase 2 on the fly and packed: to the bit; the gradient segments'
    # two bands summed: within 1e-5 of scale, as their atomic adds land in
    # any order) on the four unlit cameras above and on two lit scenes; and
    # against its plain band pass (ops/brick_march.py) on one unlit camera
    # (every brick) and on the lit scenes' last brick, held as above.
    LIT_FORMS = ("segment_lit", "scatter_lit", "scatter_lookup")
    band_counts = {f"K7_{form}": 0 for form in K7_FORMS + LIT_FORMS}

    def band_launch(mode, launch):
        """``launch()``, a band form of K7; its launches, read from the
        kernels' own counts, are added to ``band_counts``, and it must have
        launched ``mode`` once."""
        before = dict(cuda_march.LAUNCHES_BY_MODE)
        result = launch()
        delta = {k: v - before[k] for k, v in cuda_march.LAUNCHES_BY_MODE.items()}
        if delta[mode] != 1 or sum(delta.values()) != 1:
            raise RuntimeError(f"a band's {mode} launched {delta}, not one {mode}")
        for k, v in delta.items():
            if k in band_counts:
                band_counts[k] += v
        return result
    band_err = {"vs_whole_forward": 0.0, "vs_whole_gradients_of_scale": 0.0,
                "vs_plain_forward": 0.0, "vs_plain_gradients_of_scale": 0.0}
    band_plain_ms = {form: 0.0 for form in K7_FORMS + LIT_FORMS}

    def band_compare(name, scene, opts, g, plain_bricks):
        """Each K7 form of ``scene`` over two bands against the whole launch
        and, on the bricks ``plain_bricks``, against its plain band pass."""
        lit = scene.has_lighting
        lookup = lit and scene.has_gradient_volumes
        seg, scat = ("segment_lit", "scatter_lookup" if lookup else "scatter_lit") if lit else (
            "segment", "scatter")
        split = bricks.split_bricks(scene, make_mesh(BRICKS))
        fwd = bricks._forward(split, opts, 0.0, fast=True)
        up_dots = bricks._upstream([brick_march.own_dot(g, own) for own in fwd.own],
                                   fwd.ascending, torch.cumsum, 0.0)
        bands_ = [(y0, BRICK_BAND) for y0 in range(0, opts.height, BRICK_BAND)]
        assert bands_[-1][0] + BRICK_BAND == opts.height, name
        out = {"bands": bands_, "grads_vs_whole_of_scale": {}, "grads_vs_plain_of_scale": {},
               "plain_bricks": sorted(plain_bricks)}

        def worst(key, what, err):
            out[what][key] = max(out[what].get(key, 0.0), err)

        for brick, w_in, up, entry in zip(split.bricks, fwd.w_in, up_dots, fwd.entry):
            tag = f"{name} brick {brick.index}"
            w_in, up = w_in.contiguous(), up.contiguous()
            w_own, _ = cuda_bricks.brick_transmittance(brick, opts)
            own, w_out = cuda_bricks.brick_segment(brick, opts, 0.0, w_in, entry)
            whole = cuda_bricks.brick_gradients(brick, opts, 0.0, g, fwd.image, w_in, up, entry)
            summed = {}
            for y0, rows in bands_:
                def cut(t):
                    return t[y0:y0 + rows].contiguous()

                band_kw = dict(y_offset=y0, n_rows=rows)
                b_w, b_entry = band_launch("K7_transmittance", lambda: cuda_bricks
                                           .brick_transmittance(brick, opts, **band_kw))
                b_own, b_out = band_launch(f"K7_{seg}", lambda: cuda_bricks.brick_segment(
                    brick, opts, 0.0, cut(w_in), b_entry, **band_kw))
                want_entry = entry.rows(y0, rows)
                if not (torch.equal(b_w, cut(w_own)) and torch.equal(b_own, cut(own))
                        and torch.equal(b_out, cut(w_out))
                        and torch.equal(b_entry.step, want_entry.step)
                        and torch.equal(b_entry.state, want_entry.state)
                        and b_entry.made_for == want_entry.made_for):
                    raise RuntimeError(f"{tag} rows {y0}-{y0 + rows - 1}: a band's phase 1 or "
                                       f"{seg} is not the whole launch's rows")
                b_grads = band_launch(f"K7_{scat}", lambda: cuda_bricks.brick_gradients(
                    brick, opts, 0.0, cut(g), cut(fwd.image), cut(w_in), cut(up), b_entry,
                    **band_kw))
                for key, value in b_grads.items():
                    summed[key] = value if key not in summed else summed[key] + value
                if brick.index not in plain_bricks:
                    continue
                (p_w, p_entry), ms = timed(lambda: brick_march.transmittance_pass(
                    brick, opts, 0.0, **band_kw))
                band_plain_ms["transmittance"] += ms
                (p_own, p_out), ms = timed(lambda: brick_march.shaded_pass(
                    brick, opts, 0.0, cut(w_in), entry=b_entry, **band_kw))
                band_plain_ms[seg] += ms
                if not (torch.equal(b_w, p_w) and torch.equal(b_entry.step, p_entry.step)
                        and torch.equal(b_entry.state, p_entry.state)):
                    raise RuntimeError(f"{tag} rows {y0}-{y0 + rows - 1}: a band's phase 1 is "
                                       "not its plain pass")
                mode = "K5" if lookup else ("K4" if lit else "K1")
                err = max(check(f"{tag} band {seg}", b_own, p_own, *tol[mode], None),
                          check(f"{tag} band exit opacity", b_out, p_out, *tol[mode], None))
                if not lookup and err:  # as the whole launches, exact but for lookup
                    raise RuntimeError(f"{tag}: a band's {seg} is {err:.3e} off its plain pass")
                band_err["vs_plain_forward"] = max(band_err["vs_plain_forward"], err)
                want, ms = timed(lambda: brick_march.replay_pass(
                    brick, opts, 0.0, cut(g), cut(fwd.image), cut(w_in), cut(up),
                    angle_floor=True, entry=b_entry, **band_kw))
                band_plain_ms[scat] += ms
                for key, value in b_grads.items():
                    value, ref = value.double(), want[key].double()
                    err = float((value - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
                    limit = BRICK_GRAD_TOL if (key in GRID_NAMES or not lit) else GRAD_TOL
                    if err > limit:
                        raise RuntimeError(f"{tag} band {y0} {key}: {err:.3e} of scale off the "
                                           "plain gradient segment")
                    worst(key, "grads_vs_plain_of_scale", err)
            for key, value in whole.items():
                err = (float((summed[key].double() - value.double()).abs().max())
                       / max(float(value.abs().max()), 1e-30))
                if err > RANK_GRAD_TOL:
                    raise RuntimeError(f"{tag} {key}: the bands' gradient segments summed are "
                                       f"{err:.3e} of scale off the whole launch's")
                worst(key, "grads_vs_whole_of_scale", err)
        band_err["vs_whole_gradients_of_scale"] = max(
            [band_err["vs_whole_gradients_of_scale"], *out["grads_vs_whole_of_scale"].values()])
        band_err["vs_plain_gradients_of_scale"] = max(
            [band_err["vs_plain_gradients_of_scale"], *out["grads_vs_plain_of_scale"].values()])
        return out

    band_cases = {}
    for i, (name, scene, plain_bricks) in enumerate((
            ("dz_positive", brick_scene(PLAIN["volume"], (10, 5, 0)), range(BRICKS)),
            ("dz_negative_aliased", brick_scene(PLAIN["volume"], (180, 20, 0), ab_aliased=True),
             ()),
            ("dz_mixed", brick_scene(PLAIN["volume"], (88, 0, 0)), ()),
            ("dz_positive_absorption_other_shape",
             brick_scene(PLAIN["volume"], (10, 5, 0), ab_other_shape=True), ()),
            ("lit_otf_two_lights", flagship(PLAIN["volume"], "K4", ab_aliased=False, n_lights=2,
                                            noise=0.05), (BRICKS - 1,)),
            ("lit_lookup_packed", flagship(PLAIN["volume"], "K5", ab_aliased=False, noise=0.05),
             (BRICKS - 1,)))):
        band_cases[name] = band_compare(name, scene, scene.options(PLAIN["width"],
                                                                   PLAIN["height"]),
                                        cotangent(PLAIN["height"], PLAIN["width"], seed=30 + i),
                                        set(plain_bricks))
        del scene
    record({"phase": "bricks_vs_plain", "volume": PLAIN["volume"],
            "image": [PLAIN["width"], PLAIN["height"]], "bricks": BRICKS, "volume_noise": 0.05,
            "tolerance": {"atol": tol["K1"][0], "rtol": tol["K1"][1],
                          "gradients_of_scale": BRICK_GRAD_TOL},
            "cases": bricks_cases,
            "lit": {"volume": LIT_BRICKS["volume"], "image": [lit_w, lit_h],
                    "plain_rows": LIT_BRICKS["band"], "cases": lit_cases,
                    "plain_ms": lit_plain_ms,
                    "tolerance": {"phase_2_otf": 0.0, "phase_2_lookup": tol["K5"],
                                  "phase_2_lookup_packed_vs_unpacked": 0.0,
                                  "grids_of_scale": BRICK_GRAD_TOL, "others_of_scale": GRAD_TOL}},
            "bands": {"rows": BRICK_BAND, "cases": band_cases, "max_err": band_err,
                      "launches": band_counts, "plain_ms": band_plain_ms,
                      "tolerance": {"vs_whole_forward": 0.0,
                                    "vs_whole_gradients_of_scale": RANK_GRAD_TOL,
                                    "vs_plain": "as the whole launches above"}}})

    # ---- 9. the z-brick main path at 256^3 / 512^2 ------------------------
    scene = brick_scene(MAIN["volume"], (125, 25, 0))      # the noisy K3 scene
    dense = brick_scene(MAIN["volume"], (125, 25, 0), factor_absorption=4.0,
                        opacity_threshold=0.3)
    opts = scene.options(size, size)
    single = render_forward_fast(scene, opts)
    single_dense_steps = torch.zeros((size, size), dtype=torch.int32, device=dev)
    single_dense = render_forward_fast(dense, opts, steps=single_dense_steps)
    splits = {n: bricks.split_bricks(scene, make_mesh(n)) for n in (BRICKS, 2 * BRICKS)}
    dense_splits = {n: bricks.split_bricks(dense, make_mesh(n)) for n in (BRICKS, 2 * BRICKS)}
    # the first training step's state, whole and cut
    params, static_scene = train.split_params(scene)
    bparams, bstatic = bricks.split_params_bricked(scene, make_mesh(BRICKS))
    with torch.no_grad():
        params["emission"].mul_(1.3).add_(0.05)
        for p in bparams["emission"]:
            p.mul_(1.3).add_(0.05)
    with torch.no_grad():
        merged = train.merge_params(params, static_scene)
        img0 = render_forward_fast(merged, opts)
        g0 = 2.0 * (img0 - single)
        _, want_grads = voxel_grads_fast(merged, opts, g0, image=img0)
        # the plain passes on the last brick (every brick at 24^3 in phase 8):
        # a plain pass costs a launch a step whatever the rows
        main_compare = bricks_compare("main shapes", merged, opts, g0, band=BAND,
                                      held=(BRICKS - 1,))
        main_compare.pop("image")
    boptimizer = torch.optim.Adam(bricks.param_leaves(bparams), lr=TRAIN_LR["K3"])
    bmerged = bricks.merge_params_bricked(bparams, bstatic)

    torch.cuda.synchronize()
    cuda_march.reset_launch_counts()
    brick_images = {n: bricks.render_forward_bricked_fast(split, opts)
                    for n, split in splits.items()}
    dense_images = {n: bricks.render_forward_bricked_fast(split, opts)
                    for n, split in dense_splits.items()}
    render_launches = dict(cuda_march.LAUNCHES_BY_MODE)
    img_b, got_grads = bricks.voxel_grads_bricked_fast(bmerged, opts, g0)
    grads_launches = dict(cuda_march.LAUNCHES_BY_MODE)
    brick_losses = [
        float(bricks.train_step_fast_bricked(bparams, boptimizer, bstatic, opts, single))
        for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    brick_launches = {form: cuda_march.LAUNCHES_BY_MODE[f"K7_{form}"] for form in K7_FORMS}
    other = {k: v for k, v in cuda_march.LAUNCHES_BY_MODE.items() if not k.startswith("K7") and v}
    renders = 2 * (BRICKS + 2 * BRICKS)
    expected = {"transmittance": renders + BRICKS + TRAIN_STEPS * BRICKS,
                "segment": renders + BRICKS + TRAIN_STEPS * BRICKS,
                "scatter": BRICKS + TRAIN_STEPS * BRICKS}
    if (brick_launches != expected or other
            or render_launches["K7_transmittance"] != renders
            or render_launches["K7_segment"] != renders or render_launches["K7_scatter"] != 0
            or grads_launches["K7_scatter"] != BRICKS):
        raise RuntimeError(f"the brick main path launched {brick_launches} (others {other}), "
                           f"expected {expected}")
    if not (all(np.isfinite(brick_losses))
            and all(b < a for a, b in zip(brick_losses, brick_losses[1:]))):
        raise RuntimeError(f"the bricked loss did not fall: {brick_losses}")
    main_images = {f"{n}_bricks": image_tolerance(f"main path {n} bricks", img, single)
                   for n, img in brick_images.items()}
    for n, img in dense_images.items():
        main_images[f"dense_threshold_0.3_{n}_bricks"] = image_tolerance(
            f"main path dense {n} bricks", img, single_dense)
    main_images["dense_threshold_0.3_samples_per_ray"] = (
        float(single_dense_steps.sum()) / (size * size))
    main_images["first_step"] = image_tolerance("main path first step", img_b, img0)
    first_step_errs = check_grads(
        "bricked first step", {k: bricks.assemble(v) if isinstance(v, list) else v
                               for k, v in got_grads.items()}, want_grads, None,
        keys=want_grads.keys())
    if max(first_step_errs.values()) > BRICK_GRAD_TOL:
        raise RuntimeError(f"bricked and single-device gradients differ: {first_step_errs}")
    record({"phase": "bricks_main_path",
            "entry": ["render_forward_bricked_fast", "voxel_grads_bricked_fast",
                      "train_step_fast_bricked"],
            "volume": MAIN["volume"], "image": size, "bricks": [BRICKS, 2 * BRICKS],
            "volume_noise": 0.05, "launches": brick_launches, "expected_launches": expected,
            "vs_single_device_kernel": main_images,
            "first_step_grads_vs_voxel_grads_fast_of_scale": first_step_errs,
            "tolerance_of_scale": BRICK_GRAD_TOL, "steps": TRAIN_STEPS, "optimizer": "Adam",
            "lr": TRAIN_LR["K3"], "losses": brick_losses,
            "kernels_vs_plain_band": main_compare})
    del splits, dense_splits, dense, brick_images, dense_images, single_dense, bmerged, got_grads
    del want_grads, img_b
    torch.cuda.empty_cache()

    # ---- 10. timing the z-brick path with 4 bricks at 256^3 / 512^2 -------
    def brick_state(split, g):
        """The inputs of every brick's launch forms: phase 1's forward, and
        per brick w_in, up_dot and the entry record, made once outside the
        timed calls."""
        fwd = bricks._forward(split, opts, 0.0, fast=True)
        up_dots = [u.contiguous() for u in bricks._upstream(
            [brick_march.own_dot(g, own) for own in fwd.own], fwd.ascending, torch.cumsum, 0.0)]
        return fwd, [w.contiguous() for w in fwd.w_in], up_dots

    def time_forms(split, g, fwd, w_ins, up_dots):
        """Each launch form over all bricks (CUDA events, warm, median of 5),
        and the samples each form took."""
        samples = {"transmittance": 0, "segment": 0}
        for brick, w_in, entry in zip(split.bricks, w_ins, fwd.entry):
            steps = torch.zeros((size, size), dtype=torch.int32, device=dev)
            cuda_bricks.brick_transmittance(brick, opts, steps=steps)
            samples["transmittance"] += int(steps.sum())
            cuda_bricks.brick_segment(brick, opts, 0.0, w_in, entry, steps=steps)
            samples["segment"] += int(steps.sum())
        samples["scatter"] = samples["segment"]  # g is nonzero on every ray that marches
        form_ms = {
            "transmittance": median_ms(lambda: [cuda_bricks.brick_transmittance(b, opts)
                                                for b in split.bricks]),
            "segment": median_ms(lambda: [cuda_bricks.brick_segment(b, opts, 0.0, w, e)
                                          for b, w, e in zip(split.bricks, w_ins, fwd.entry)]),
            "scatter": median_ms(lambda: [
                cuda_bricks.brick_gradients(b, opts, 0.0, g, fwd.image, w, u, e)
                for b, w, u, e in zip(split.bricks, w_ins, up_dots, fwd.entry)]),
        }
        return samples, form_ms

    def carried_adds(split, w_ins, fwd):
        """The gradient segment's atomic adds a sample over all bricks, from
        the plain walk's positions (corner_flushes): both grids are carried
        where absorption has emission's shape."""
        samples = flushes = 0
        for brick, w_in, entry in zip(split.bricks, w_ins, fwd.entry):
            n, f = corner_flushes(brick, opts, w_in, entry)
            samples, flushes = samples + n, flushes + f
        grids = 1 + (not split.bricks[0].scene.absorption_aliased)
        return {"samples": samples, "flushes_per_grid": flushes,
                "atomic_adds_per_sample": grids * flushes / samples,
                "atomic_adds_per_sample_uncarried": 8 * grids}

    def cached_loads(split, fwd, kernel_samples):
        """The corner loads a sample over all bricks that a per-ray corner
        cache would make for phase 1, from the plain walk's positions
        (corner_loads); the walk must take the samples the kernel took."""
        samples = loads = 0
        for brick, entry in zip(split.bricks, fwd.entry):
            n, f = corner_loads(brick, opts, None, entry)
            samples, loads = samples + n, loads + f
        if samples != kernel_samples:
            raise RuntimeError(f"phase 1 took {kernel_samples} samples, its plain walk {samples}")
        return {"samples": samples, "loads": loads, "loads_per_sample": loads / samples,
                "loads_per_sample_uncached": 8}

    pixels = size * size * 4

    def form_cells(split, samples, form_ms, plain):
        grid_bytes = {"em": sum(b.scene.emission.data.numel() * 4 for b in split.bricks),
                      "ab": sum(b.scene.absorption.data.numel() * 4 for b in split.bricks)}
        # each brick reads its padded grids once and its per-ray planes (the
        # entry record 5 floats) once, and writes its own outputs once
        form_bytes = {
            "transmittance": grid_bytes["ab"] + BRICKS * pixels * (1 + 5),
            "segment": grid_bytes["em"] + grid_bytes["ab"] + BRICKS * pixels * (5 + 1 + 3 + 1),
            "scatter": (2 * (grid_bytes["em"] + grid_bytes["ab"])
                        + BRICKS * pixels * (5 + 3 + 3 + 1 + 1 + 2)),
        }
        # the operation counts fetch absorption at the emission's corners
        assert all(b.scene.absorption.data.shape == b.scene.emission.data.shape
                   for b in split.bricks)
        out = {}
        for form in K7_FORMS:
            flops = samples[form] * brick_flops_per_sample(form, ab_aliased=False)
            bound = {"bytes": form_bytes[form] / PEAK_BYTES_PER_S * 1e3,
                     "operations": flops / PEAK_FP32_FLOPS * 1e3}
            bound_by = max(bound, key=bound.get)
            out[form] = {
                "ms": form_ms[form][0], "ms_all": form_ms[form][1], "launches_timed": BRICKS,
                "samples": samples[form], "flops": flops, "bytes": form_bytes[form],
                "bound_ms": bound[bound_by], "bound_by": bound_by}
            if plain is not None:
                out[form].update(plain_ms=plain["plain_ms"][form], plain_rows=plain["plain_rows"],
                                 plain_cell=plain["plain_cell"])
        return out

    with torch.no_grad():
        for key, value in bparams.items():  # both sides time the same state
            params[key].copy_(bricks.assemble(value) if isinstance(value, list) else value)
        split = bricks.merge_params_bricked(bparams, bstatic)
        merged = train.merge_params(params, static_scene)
        g = 2.0 * (bricks._forward(split, opts, 0.0, fast=True).image - single)
        fwd, w_ins, up_dots = brick_state(split, g)
        samples, form_ms = time_forms(split, g, fwd, w_ins, up_dots)
        adds = carried_adds(split, w_ins, fwd)
        loads = cached_loads(split, fwd, samples["transmittance"])
        single_steps = torch.zeros((size, size), dtype=torch.int32, device=dev)
        render_forward_fast(merged, opts, steps=single_steps)
        path_ms = {
            "bricked_forward": median_ms(lambda: bricks.render_forward_bricked_fast(split, opts)),
            "bricked_fwd_bwd": median_ms(lambda: bricks.voxel_grads_bricked_fast(split, opts, g)),
            "single_forward_K1": median_ms(lambda: render_forward_fast(merged, opts)),
            "single_fwd_bwd_K1_K3": median_ms(lambda: voxel_grads_fast(merged, opts, g)),
        }
    path_ms["bricked_train_step"] = median_ms(lambda: bricks.train_step_fast_bricked(
        bparams, boptimizer, bstatic, opts, single))
    optimizer = torch.optim.Adam(list(params.values()), lr=TRAIN_LR["K3"])
    path_ms["single_train_step"] = median_ms(lambda: train.train_step_fast(
        params, optimizer, static_scene, opts, single))
    brick_cells = form_cells(split, samples, form_ms, main_compare)
    brick_cells["scatter"]["atomic_adds"] = adds
    brick_cells["transmittance"]["corner_loads"] = loads

    # the dense scene: rays die mid-volume, so the walk to a brick is a
    # larger share of a ray's work
    dense = brick_scene(MAIN["volume"], (125, 25, 0), factor_absorption=4.0,
                        opacity_threshold=0.3)
    with torch.no_grad():
        dense_split = bricks.split_bricks(dense, make_mesh(BRICKS))
        g_dense = cotangent(size, size, seed=30)
        dense_fwd, dense_w_ins, dense_up = brick_state(dense_split, g_dense)
        dense_samples, dense_ms = time_forms(dense_split, g_dense, dense_fwd, dense_w_ins,
                                             dense_up)
        dense_cells = form_cells(dense_split, dense_samples, dense_ms, None)
        dense_cells["transmittance"]["corner_loads"] = cached_loads(
            dense_split, dense_fwd, dense_samples["transmittance"])
        dense_forward = median_ms(lambda: bricks.render_forward_bricked_fast(dense_split, opts))
        dense_single = median_ms(lambda: render_forward_fast(dense, opts))
    record({"phase": "bricks_timing", "volume": MAIN["volume"], "image": size, "bricks": BRICKS,
            "single_device_samples": int(single_steps.sum()),
            "forms": brick_cells,
            "paths_ms": {k: v[0] for k, v in path_ms.items()},
            "paths_ms_all": {k: v[1] for k, v in path_ms.items()},
            "dense_threshold_0.3": {"forms": dense_cells,
                                    "paths_ms": {"bricked_forward": dense_forward[0],
                                                 "single_forward_K1": dense_single[0]},
                                    "paths_ms_all": {"bricked_forward": dense_forward[1],
                                                     "single_forward_K1": dense_single[1]}}})
    del split, merged, fwd, params, bparams, bstatic, static_scene, optimizer, boptimizer
    del dense, dense_split, dense_fwd
    torch.cuda.empty_cache()

    # ---- the lit forms on the brick path at 256^3 / 512^2, 4 bricks ----------
    # Counted like phase 5: the lit bricked render of the noisy K4 scene and of
    # the K5 scene, a lit bricked gradient call and a lit bricked Adam step on
    # the K4 scene (phase 1, lit phase 2 and the lit gradient segment a brick);
    # images against K4 and K5, gradients against K6's voxel_grads_fast. Then
    # the lit forms against their plain passes at these shapes, on the last
    # brick (its offsets are the largest and its taps reach the volume's far
    # face) and a band of 32 rows through the middle: lit phase 2 of both
    # scenes, the lit segment of the K4 scene (phase 8's tolerances; the plain
    # passes cost thousands of launches a step, so one brick). Last, the two
    # lit forms over all bricks (CUDA events, warm, median of 5), with their
    # samples and bound. The K5 scene (5 % seeded noise) also takes a lookup
    # bricked gradient call and a lookup bricked Adam step (the lookup
    # gradient segment a brick), against K6L's voxel_grads_fast: the call
    # for the same cotangent, the step for the cotangent of its bricked
    # image; the lookup segment is timed over all bricks (its plain pass is
    # held in phase 8, at 32^3).
    t_phase = time.perf_counter()
    lit4 = flagship(MAIN["volume"], "K4", ab_aliased=False, noise=0.05)
    lit5 = flagship(MAIN["volume"], "K5", ab_aliased=False, noise=0.05)
    opts = lit4.options(size, size)
    with torch.no_grad():
        want4, want5 = render_forward_fast(lit4, opts), render_forward_fast(lit5, opts)
        g_lit = cotangent(size, size, seed=31)
        _, want_lit = voxel_grads_fast(lit4, opts, g_lit, image=want4)
        _, want_lookup = voxel_grads_fast(lit5, opts, g_lit, image=want5)
        split4 = bricks.split_bricks(lit4, make_mesh(BRICKS))
        split5 = bricks.split_bricks(lit5, make_mesh(BRICKS))
    lit_params, lit_static = train.split_params(lit4)
    lookup_params, lookup_static = train.split_params(lit5)
    with torch.no_grad():
        lit_params["emission"].mul_(1.3).add_(0.05)
        lookup_params["emission"].mul_(1.3).add_(0.05)
        lmerged = train.merge_params(lookup_params, lookup_static)
        limg = bricks.render_forward_bricked_fast(lmerged, opts, mesh=make_mesh(BRICKS))
        _, want_lookup_step = voxel_grads_fast(lmerged, opts, 2.0 * (limg - want5))
        del lmerged, limg
    lit_optimizer = torch.optim.Adam(list(lit_params.values()), lr=TRAIN_LR["K6"])
    lookup_optimizer = torch.optim.Adam(list(lookup_params.values()), lr=TRAIN_LR["K6L"])
    torch.cuda.synchronize()
    cuda_march.reset_launch_counts()
    img4 = bricks.render_forward_bricked_fast(split4, opts)
    img5 = bricks.render_forward_bricked_fast(split5, opts)
    img_g, got_lit = bricks.voxel_grads_bricked_fast(split4, opts, g_lit)
    img_g5, got_lookup = bricks.voxel_grads_bricked_fast(split5, opts, g_lit)
    lit_step_loss = float(bricks.train_step_fast_bricked(
        lit_params, lit_optimizer, lit_static, opts, want4, mesh=make_mesh(BRICKS)))
    lookup_step_loss = float(bricks.train_step_fast_bricked(
        lookup_params, lookup_optimizer, lookup_static, opts, want5, mesh=make_mesh(BRICKS)))
    torch.cuda.synchronize()
    lit_brick_launches = {k: v for k, v in cuda_march.LAUNCHES_BY_MODE.items() if v}
    # 2 launches a brick and render, each gradient call and step 3
    expected = {"K7_transmittance": 6 * BRICKS, "K7_segment_lit": 6 * BRICKS,
                "K7_scatter_lit": 2 * BRICKS, "K7_scatter_lookup": 2 * BRICKS}
    if lit_brick_launches != expected:
        raise RuntimeError(f"the lit brick path launched {lit_brick_launches}, expected {expected}")
    lit_main = {
        "K4_render_vs_single_device_kernel": image_tolerance("lit bricked K4", img4, want4),
        "K5_render_vs_single_device_kernel": image_tolerance("lit bricked K5", img5, want5),
        "grads_image_vs_K4": image_tolerance("lit bricked gradients' image", img_g, want4),
        "grads_vs_voxel_grads_fast_K6_of_scale": dp_grads_check(
            "lit bricked gradients", {k: bricks.assemble(v) if isinstance(v, list) else v
                                      for k, v in got_lit.items()}, want_lit),
        "train_step_fast_bricked_loss": lit_step_loss,
        "lookup_grads_image_vs_K5": image_tolerance("lookup bricked gradients' image", img_g5,
                                                    want5),
        "lookup_grads_vs_voxel_grads_fast_K6L_of_scale": dp_grads_check(
            "lookup bricked gradients", {k: bricks.assemble(v) if isinstance(v, list) else v
                                         for k, v in got_lookup.items()}, want_lookup),
        "lookup_train_step_fast_bricked_loss": lookup_step_loss,
        "lookup_step_grads_vs_K6L_of_scale": dp_grads_check(
            "lookup bricked step", {k: p.grad for k, p in lookup_params.items()},
            {k: want_lookup_step[k] for k in lookup_params})}
    for what, loss in (("lit", lit_step_loss), ("lookup", lookup_step_loss)):
        if not (np.isfinite(loss) and loss > 0.0):
            raise RuntimeError(f"the {what} bricked step's loss is {loss}")
    # the lookup segment's plain pass is held in phase 8 (at 32^3): here it
    # would take about 0.7 s a row
    lit_band = {mode: lit_bricks_compare(f"main shapes {mode}", scene, opts, g_lit,
                                         LIT_BRICKS["band"], held={BRICKS - 1},
                                         grads=mode == "K4")
                for mode, scene in (("K4", lit4), ("K5", lit5))}
    lit_main["kernels_vs_plain_band"] = lit_band

    def lit_form_cells(split, lookup):
        """Lit phase 2 (and, on the on-the-fly scene, the lit gradient
        segment) over all bricks: ms, samples, bytes and operations; the tail
        factors of phase 2's launches by block shape, a brick's and the four's
        (tail_factors); lookup, the windows' pack alone (its form's ms
        includes it); the lit segment's atomic adds a sample
        (lit_corner_flushes)."""
        fwd = bricks._forward(split, opts, 0.0, fast=True)
        w_ins = [w.contiguous() for w in fwd.w_in]
        up = [u.contiguous() for u in bricks._upstream(
            [brick_march.own_dot(g_lit, own) for own in fwd.own], fwd.ascending, torch.cumsum,
            0.0)]
        samples, planes = 0, []
        for brick, w_in, entry in zip(split.bricks, w_ins, fwd.entry):
            steps = torch.zeros((size, size), dtype=torch.int32, device=dev)
            cuda_bricks.brick_segment(brick, opts, 0.0, w_in, entry, steps=steps)
            samples += int(steps.sum())
            planes.append(steps)
        tails = {"bricks": tail_factors(planes),
                 **{f"brick_{b}": tail_factors(p) for b, p in enumerate(planes)}}
        scene0 = split.bricks[0].scene
        n_lights = scene0.light_positions.shape[0]
        roles = ["emission", "absorption", "reflection"] + (
            ["gradient_x", "gradient_y", "gradient_z"] if lookup else [])
        grid_bytes = sum(getattr(b.scene, k).data.numel() * 4 for b in split.bricks
                         for k in roles)
        lut_bytes = scene0.illumination.numel() * 4
        forms = {"segment_lit": (
            median_ms(lambda: [cuda_bricks.brick_segment(b, opts, 0.0, w, e)
                               for b, w, e in zip(split.bricks, w_ins, fwd.entry)]),
            brick_flops_per_sample("segment_lit", False, lookup=lookup, n_lights=n_lights),
            grid_bytes + BRICKS * (lut_bytes + pixels * (5 + 1 + 3 + 1)))}
        forms["scatter_lookup" if lookup else "scatter_lit"] = (
            median_ms(lambda: [cuda_bricks.brick_gradients(b, opts, 0.0, g_lit, fwd.image, w,
                                                           u, e)
                               for b, w, u, e in zip(split.bricks, w_ins, up, fwd.entry)]),
            brick_flops_per_sample("scatter_lit", False, lookup=lookup, n_lights=n_lights),
            2 * grid_bytes + BRICKS * (lut_bytes + pixels * (5 + 3 + 3 + 1 + 1 + 3
                                                             + 3 * n_lights)))
        out = {}
        extra = {"segment_lit": {"tail_factors": tails}}
        if lookup:
            extra["segment_lit"]["pack_ms"] = median_ms(
                lambda: [cuda_bricks.pack_window(b) for b in split.bricks])[0]
            extra["segment_lit"]["packed"] = cuda_bricks.pack_window(split.bricks[0]) is not None
            adds = [lookup_scatter_adds(b, opts, w, e)
                    for b, w, e in zip(split.bricks, w_ins, fwd.entry)]
            n = sum(a["samples"] for a in adds)
            if n != samples:
                raise RuntimeError(f"lit phase 2 took {samples} samples, its plain walk {n}")
            totals = {key: {k: sum(a[key][k] for a in adds) for k in adds[0][key]}
                      for key in ("adds", "voxels", "reductions", "sectors", "sectors_scalar")}
            extra["scatter_lookup"] = {"atomic_adds": {
                "samples": n, **totals,
                **{key: sum(a[key] * a["samples"] for a in adds) / n
                   for key in ("atomic_adds_per_sample", "voxels_per_sample",
                               "sectors_per_sample", "sectors_per_sample_scalar")},
                "reductions_per_sample": {k: v / n for k, v in totals["reductions"].items()}}}
        else:
            adds = [lit_corner_flushes(b, opts, w, e)
                    for b, w, e in zip(split.bricks, w_ins, fwd.entry)]
            n = sum(a["samples"] for a in adds)
            if n != samples:
                raise RuntimeError(f"lit phase 2 took {samples} samples, its plain walk {n}")
            extra["scatter_lit"] = {"atomic_adds": {
                "samples": n, "tap_adds": sum(a["tap_adds"] for a in adds),
                "flushes_per_grid": sum(a["flushes_per_grid"] for a in adds),
                "carry_grids": adds[0]["carry_grids"],
                **{key: sum(a[key] * a["samples"] for a in adds) / n
                   for key in ("atomic_adds_per_sample", "atomic_adds_per_sample_carried")}}}
        for form, ((ms, ms_all), per_sample, nbytes) in forms.items():
            flops = samples * per_sample
            bound = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3,
                     "operations": flops / PEAK_FP32_FLOPS * 1e3}
            bound_by = max(bound, key=bound.get)
            plain = {"plain_ms": lit_band["K5" if lookup else "K4"]["plain_ms"].get(form),
                     "plain_rows": LIT_BRICKS["band"],
                     "plain_cell": f"brick {BRICKS - 1} of {BRICKS}, {LIT_BRICKS['band']} "
                                   f"rows of {size}^2 through the middle"}
            if form == "scatter_lookup":  # held in phase 8
                plain = {"plain_ms": lit_cases["lookup_packed"]["plain_ms"][form],
                         "plain_rows": LIT_BRICKS["band"],
                         "plain_cell": f"brick {BRICKS - 1} of {BRICKS}, {LIT_BRICKS['band']} "
                                       f"rows of {lit_w}x{lit_h} at {LIT_BRICKS['volume']}^3"}
            out[form] = {"ms": ms, "ms_all": ms_all, "launches_timed": BRICKS,
                         "samples": samples, "flops": flops, "bytes": nbytes,
                         "bound_ms": bound[bound_by], "bound_by": bound_by, **plain,
                         **extra.get(form, {})}
        return out

    with torch.no_grad():
        lit_cells = lit_form_cells(split4, lookup=False)
        lookup_cells = lit_form_cells(split5, lookup=True)
        lit_cells["segment_lit_lookup"] = lookup_cells["segment_lit"]
        lit_cells["scatter_lookup"] = lookup_cells["scatter_lookup"]
        # the single-device kernels' one launch, for the same tails
        for mode, scene in (("K4", lit4), ("K5", lit5)):
            steps = torch.zeros((size, size), dtype=torch.int32, device=dev)
            render_forward_fast(scene, opts, steps=steps)
            lit_cells[f"single_{mode}_tail_factors"] = tail_factors(steps)
        lit_paths = {
            "single_K4_ms": median_ms(lambda: render_forward_fast(lit4, opts))[0],
            "single_K5_ms": median_ms(lambda: render_forward_fast(lit5, opts))[0],
            "single_K6_backward_ms": median_ms(lambda: voxel_grads_fast(lit4, opts, g_lit,
                                                                        image=want4))[0],
            "single_K6L_backward_ms": median_ms(lambda: voxel_grads_fast(lit5, opts, g_lit,
                                                                         image=want5))[0],
            "bricked_grads_K5_ms": median_ms(lambda: bricks.voxel_grads_bricked_fast(
                split5, opts, g_lit))[0],
            "bricked_forward_K4_ms": median_ms(lambda: bricks.render_forward_bricked_fast(
                split4, opts))[0],
            "bricked_forward_K5_ms": median_ms(lambda: bricks.render_forward_bricked_fast(
                split5, opts))[0]}
    lit_paths["bricked_train_step_K4_ms"] = median_ms(lambda: bricks.train_step_fast_bricked(
        lit_params, lit_optimizer, lit_static, opts, want4, mesh=make_mesh(BRICKS)))[0]
    lit_paths["bricked_train_step_K5_ms"] = median_ms(lambda: bricks.train_step_fast_bricked(
        lookup_params, lookup_optimizer, lookup_static, opts, want5, mesh=make_mesh(BRICKS)))[0]
    record({"phase": "bricks_lit_main_path", "volume": MAIN["volume"], "image": size,
            "bricks": BRICKS, "volume_noise_K4": 0.05, "volume_noise_K5": 0.05,
            "launches": lit_brick_launches,
            "expected_launches": expected, **lit_main, "forms": lit_cells, "ms": lit_paths,
            "seconds": time.perf_counter() - t_phase})
    del lit4, lit5, split4, split5, want4, want5, want_lit, got_lit, img4, img5, img_g
    del lit_params, lit_static, lit_optimizer, lookup_params, lookup_static, lookup_optimizer
    del want_lookup, want_lookup_step, got_lookup, img_g5
    torch.cuda.empty_cache()

    # ---- 11. another version's K1-K7 against the checkout's -----------------
    if args.parent:
        t_phase = time.perf_counter()
        turns = {"parent": [], "new": []}
        # the parent's first lookup turn writes the grids every other turn's
        # are held against
        import tempfile
        ref_dir = tempfile.mkdtemp(prefix="chip_smoke_ref_")
        # one process a version, started once; each runs a turn when asked,
        # so only one of them uses the card at a time
        procs = {who: subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--turn", "--repo",
             os.path.abspath(args.parent if who == "parent" else args.repo),
             "--grids-ref", os.path.join(ref_dir, "lookup_grids.pt")],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for who in turns}

        def read_until(who, phase):
            seen = []
            for line in procs[who].stdout:
                seen.append(line)
                if line.startswith('{"phase": "%s"' % phase):
                    return json.loads(line)
            raise RuntimeError(f"the {who} turn failed:\n{''.join(seen)[-8000:]}")

        try:
            for who in procs:  # both built and idle before the first turn
                read_until(who, "ready")
            for who in ("parent", "new", "new", "parent"):
                procs[who].stdin.write("turn\n")
                procs[who].stdin.flush()
                turns[who].append(read_until(who, "turn"))
            for proc in procs.values():
                proc.stdin.close()
                proc.wait(timeout=120)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            shutil.rmtree(ref_dir, ignore_errors=True)

        def compare_turns(get, bound_ms):
            parent_ms = [get(t) for t in turns["parent"]]
            new_ms = [get(t) for t in turns["new"]]
            return {"parent_ms": parent_ms, "ms": new_ms, "parent_mean_ms": float(np.mean(parent_ms)),
                    "mean_ms": float(np.mean(new_ms)), "bound_ms": bound_ms}

        every = turns["parent"] + turns["new"]
        compared = {}
        grads = ("backward_ms", "fwd_bwd_ms", "train_step_ms")
        forwards = [f"{m}_{c['volume']}_{c['image']}" for m in ("K1", "K4", "K5")
                    for c in (MAIN, BIG)]
        k2 = [f"K2_{MAIN['volume']}_{MAIN['image']}", f"K2_{BIG['volume']}_{BIG['image']}",
              f"K2_lit_{MAIN['volume']}_{MAIN['image']}"]
        for key, metrics in [*((k, ("ms",)) for k in forwards),
                             ("K3_256_512", grads), ("K6_256_512", grads),
                             *((k, grads) for k in k2)]:
            compared[key] = {metric: compare_turns(lambda t: t["march"][key][metric],
                                                   cells[key]["bound_ms"])
                             for metric in metrics}
            if metrics == ("ms",):
                # K1, K4 and K5 change only how they load, never the
                # arithmetic: one image in both versions
                if len({t["march"][key]["image_sha1"] for t in every}) != 1:
                    raise RuntimeError(f"{key}: the parent's image differs from the checkout's")
                compared[key]["images_equal"] = True
            if key in k2:
                # K2 has no atomics: its planes and gradients are the parent's
                # to the bit, whatever its fetch or block
                if len({t["march"][key]["planes_sha1"] for t in every}) != 1:
                    raise RuntimeError(f"{key}: the parent's planes differ from the checkout's")
                compared[key]["planes_equal"] = True
            packs = [t["march"][key]["pack_ms"] for t in turns["new"]
                     if "pack_ms" in t["march"][key]]
            if packs:
                compared[key]["pack_ms"] = packs
        # the forward phases keep their arithmetic: one bricked image, one
        # exit opacity, one phase 1 opacity and entry record on both scenes
        names = ("image_sha1", "w_out_sha1", "phase1_w_sha1", "phase1_entry_sha1",
                 "dense_phase1_w_sha1", "dense_phase1_entry_sha1")
        for name in names:
            if len({t["bricks"][name] for t in every}) != 1:
                raise RuntimeError(f"K7: the parent's {name[:-5]} differs from the checkout's")
        form_bounds = {**{form: c["bound_ms"] for form, c in brick_cells.items()},
                       "transmittance_dense": dense_cells["transmittance"]["bound_ms"]}
        compared[f"K7_{MAIN['volume']}_{MAIN['image']}_{BRICKS}_bricks"] = {
            "equal": [name[:-5] for name in names],
            **{metric: compare_turns(lambda t: t["bricks"]["ms"][metric],
                                     form_bounds.get(metric))
               for metric in turns["new"][0]["bricks"]["ms"]}}
        # the lit forms keep their arithmetic: one lit contribution and exit
        # opacity a brick and one lit bricked image on both scenes; the lit
        # segment's grids within 1e-5 of scale of the parent's (atomic adds)
        lit_names = ("otf_segment_sha1", "otf_image_sha1", "lookup_segment_sha1",
                     "lookup_image_sha1")
        for name in lit_names:
            if len({t["lit"][name] for t in every}) != 1:
                raise RuntimeError(f"lit K7: the parent's {name[:-5]} differs from the checkout's")
        lit_grid_err = grids_err(torch.load(turns["new"][-1]["lit"]["lit_grids"]),
                                 torch.load(turns["parent"][-1]["lit"]["lit_grids"]))
        for key in lit_grid_err:
            if lit_grid_err[key] > BRICK_GRAD_TOL:
                raise RuntimeError(f"lit K7 {key}: the lit segment's grids are "
                                   f"{lit_grid_err[key]:.3e} of scale off the parent's")
        for t in every:
            shutil.rmtree(os.path.dirname(t["lit"]["lit_grids"]), ignore_errors=True)
        lit_bounds = {"segment_lit_otf": lit_cells["segment_lit"]["bound_ms"],
                      "segment_lit_lookup": lit_cells["segment_lit_lookup"]["bound_ms"],
                      "scatter_lit": lit_cells["scatter_lit"]["bound_ms"]}
        lit_ms = turns["new"][0]["lit"]["ms"]
        compared[f"K7_lit_{MAIN['volume']}_{MAIN['image']}_{BRICKS}_bricks"] = {
            "equal": [name[:-5] for name in lit_names],
            "grids_err_of_scale_vs_parent": lit_grid_err,
            **{metric: compare_turns(lambda t: t["lit"]["ms"][metric], lit_bounds.get(metric))
               for metric in lit_ms if metric in turns["parent"][0]["lit"]["ms"]},
            **{f"{metric}_ms": [t["lit"]["ms"][metric] for t in turns["new"]]
               for metric in lit_ms if metric not in turns["parent"][0]["lit"]["ms"]}}
        # K6L and the lookup segment: their grids held against the parent's
        # first turn's within TURN_GRID_TOL of scale in each turn (raised there)
        lookup_bounds = {"K6L_backward": cells["K6L_256_512"]["bound_ms"],
                         "scatter_lookup": lit_cells["scatter_lookup"]["bound_ms"]}
        compared[f"lookup_{MAIN['volume']}_{MAIN['image']}_{BRICKS}_bricks"] = {
            "grids_err_of_scale_vs_parent": [t["lookup"].get("grids_err_of_scale_vs_ref")
                                             for t in every],
            **{metric: compare_turns(lambda t: t["lookup"]["ms"][metric],
                                     lookup_bounds.get(metric))
               for metric in turns["new"][0]["lookup"]["ms"]}}
        # K2L has no atomics: its planes and gradients are the parent's to the
        # bit, whatever its fetch or block
        if len({t["k2l"]["planes_sha1"] for t in every}) != 1:
            raise RuntimeError("K2L: the parent's planes differ from the checkout's")
        k2l_bound = cells[f"K2L_{MAIN['volume']}_{MAIN['image']}"]["bound_ms"]
        k2l_ms, k2l_parent = turns["new"][0]["k2l"]["ms"], turns["parent"][0]["k2l"]["ms"]
        compared[f"K2L_{MAIN['volume']}_{MAIN['image']}"] = {
            "planes_equal": True,
            **{metric: compare_turns(lambda t: t["k2l"]["ms"][metric],
                                     k2l_bound if metric in ("backward_ms", "kernel_ms") else None)
               for metric in k2l_ms if metric in k2l_parent},
            **{metric: [t["k2l"]["ms"][metric] for t in turns["new"]]
               for metric in k2l_ms if metric not in k2l_parent}}
        record({"phase": "parent_vs_new", "parent": args.parent, "order": "parent, new, new, parent",
                "reps": 5,
                "parent_ptxas": {**turns["parent"][0]["march"]["ptxas"],
                                 **turns["parent"][0]["bricks"]["ptxas"]},
                "turn_seconds": {who: [t["seconds"] for t in ts] for who, ts in turns.items()},
                "cells": compared, "seconds": time.perf_counter() - t_phase})

    # ---- 12. rays-DP against the single-device kernels at 128^3 / 256x192 --
    # Five bands on the one card, the last one shorter (bands(192, 5): 39
    # rows each, 36 in the last). A band's rays are the whole image's, so
    # K1, K4 and K5 give the single launch's image bit for bit. K3 and K6 add
    # the same per-sample atomic adds, split over the bands, into one set of
    # grids: within the carried grids' 1e-5 of scale, other keys GRAD_TOL.

    # imported here, not above: phase 11's turns import older versions of the port
    from volume_renderer_tpu_torch.parallel import pallas_dp, sharding
    from volume_renderer_tpu_torch.parallel.mesh import make_mesh_2d

    t_phase = time.perf_counter()
    dp_mesh = make_mesh(DP_BANDS)
    dp_compare = {"bands": sharding.bands(COMPARE["height"], DP_BANDS)}
    for mode in ("K1", "K4", "K5"):
        scene = flagship(COMPARE["volume"], mode, ab_aliased=False)
        opts = scene.options(COMPARE["width"], COMPARE["height"])
        single = render_forward_fast(scene, opts)
        got = pallas_dp.render_forward_fast_sharded(scene, opts, mesh=dp_mesh)
        torch.cuda.synchronize()
        if not torch.equal(got, single):
            raise RuntimeError(f"rays-DP {mode}: the bands' image is "
                               f"{float((got - single).abs().max()):.3e} off the single launch's")
        dp_compare[mode] = {"max_abs_err": 0.0, "bit_equal": True}
    # K3 also on an unlit scene with a reflection volume of its own: its
    # zeroed grid is one of the set the bands share, not one a band; K6L's
    # bands (the lookup scene's pack made once for them) scatter into the
    # three gradient volumes' grids too
    for case, fwd_mode in (("K3", "K1"), ("K3_own_reflection", "K1"), ("K6", "K4"),
                           ("K6L", "K5")):
        mode = "K3" if fwd_mode == "K1" else "K6"
        scene = flagship(COMPARE["volume"], fwd_mode, ab_aliased=False, noise=0.05)
        if case == "K3_own_reflection":
            scene = scene.replace(reflection=Volume.create(scene.emission.data * 0.8))
        opts = scene.options(COMPARE["width"], COMPARE["height"])
        g = cotangent(COMPARE["height"], COMPARE["width"], seed=40 + len(dp_compare))
        img, want = voxel_grads_fast(scene, opts, g)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dp_img, got = pallas_dp.voxel_grads_fast_sharded(scene, opts, g, mesh=dp_mesh)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        if not torch.equal(dp_img, img):
            raise RuntimeError(f"rays-DP {case}: the bands' image differs")
        # one set of grids however many bands, and for K6L one pack of four
        # grids (eight while it is made, before the grids: api/planner.py,
        # _pack_bytes) and beside it the bands' accumulators, one set a
        # device (ops/cuda_grads.py, zero_accumulators: four grids, two more
        # with absorption and reflection of emission's shape, as here); the
        # rest (the image, the per-ray planes, the parameters' sums) is
        # under a megabyte here
        grid = scene.emission.data.numel() * 4
        n_grids = len(cuda_grads.zero_grids(scene))
        pack_grids = 4 + 4 + 2 * cuda_grads.has_pair(scene) if case == "K6L" else 0
        if peak > (n_grids + pack_grids + 0.5) * grid:
            raise RuntimeError(f"rays-DP {case}: the backward took {peak / 2 ** 20:.1f} MiB at "
                               f"its peak, more than its {n_grids} grids of "
                               f"{grid / 2 ** 20:.1f} MiB, {pack_grids} of the pack and the "
                               "accumulators and half a grid")
        cell = {"err_of_scale": dp_grads_check(f"rays-DP {case}", got, want),
                "peak_mib": peak / 2 ** 20, "grids": n_grids, "pack_grids": pack_grids,
                "grid_mib": grid / 2 ** 20}
        if case == "K3_own_reflection" and bool(got["reflection"].any()):
            raise RuntimeError("the unlit rays-DP reflection gradient is not zero")
        if mode == "K6":
            cell["factor_reflection"] = [float(got["factor_reflection"]),
                                         float(want["factor_reflection"])]
            if not cell["factor_reflection"][0] != 0.0:
                raise RuntimeError("the lit rays-DP gradient of factor_reflection is zero")
        dp_compare[case] = cell
        del scene, got, want
    record({"phase": "dp_vs_single", "volume": COMPARE["volume"],
            "image": [COMPARE["width"], COMPARE["height"]], "bands": DP_BANDS,
            "device": "every band on cuda:0", "volume_noise": 0.05,
            "tolerance_of_scale": {"grids": BRICK_GRAD_TOL, "others": GRAD_TOL},
            "images_bit_equal": ["K1", "K4", "K5"], "cases": dp_compare,
            "seconds": time.perf_counter() - t_phase})
    torch.cuda.empty_cache()

    # ---- 13. the rays-DP main path at 256^3 / 512^2 -------------------------
    t_phase = time.perf_counter()
    dp_mesh = make_mesh(DP_MAIN_BANDS)
    dp_scenes = {mode: flagship(MAIN["volume"], mode, ab_aliased=False)
                 for mode in ("K1", "K4", "K5")}
    opts = dp_scenes["K1"].options(size, size)
    singles = {mode: render_forward_fast(s, opts) for mode, s in dp_scenes.items()}
    # K5's pack is made once a render, not once a band: counted where it is called
    packs, pack = [0], cuda_march.pack_lookup

    def counted_pack(scene):
        packs[0] += 1
        return pack(scene)

    cuda_march.pack_lookup = pallas_dp.pack_lookup = counted_pack
    try:
        torch.cuda.synchronize()
        cuda_march.reset_launch_counts()
        dp_images = {mode: pallas_dp.render_forward_fast_sharded(s, opts, mesh=dp_mesh)
                     for mode, s in dp_scenes.items()}
        torch.cuda.synchronize()
        dp_render_launches = dict(cuda_march.LAUNCHES_BY_MODE)
    finally:
        cuda_march.pack_lookup = pallas_dp.pack_lookup = pack
    expected = {k: DP_MAIN_BANDS if k in ("K1", "K4", "K5") else 0 for k in dp_render_launches}
    want_packs = 1 if dev.type == "cuda" else 0  # the plain version reads no pack
    if dp_render_launches != expected or packs[0] != want_packs:
        raise RuntimeError(f"the rays-DP render launched {dp_render_launches} and packed "
                           f"{packs[0]} times, expected {expected} and {want_packs}")
    for mode, img in dp_images.items():
        if not (torch.equal(img, singles[mode]) and float(img.amax()) > 0):
            raise RuntimeError(f"the rays-DP {mode} render differs from the single launch's")

    # the training steps: the first step's gradients against the single kernels
    dp_runs, dp_first, dp_timing = {}, {}, {}
    dp_train = {}
    for mode, fwd_mode in (("K3", "K1"), ("K6", "K4"), ("K6L", "K5")):
        scene = flagship(MAIN["volume"], fwd_mode, ab_aliased=False, noise=0.05)
        target = render_forward_fast(scene, opts)
        params, static_scene = train.split_params(scene)
        with torch.no_grad():
            params["emission"].mul_(1.3).add_(0.05)
            merged = train.merge_params(params, static_scene)
            img = render_forward_fast(merged, opts)
            g = 2.0 * (img - target)
            _, want = voxel_grads_fast(merged, opts, g, image=img)
            dp_img, got = pallas_dp.voxel_grads_fast_sharded(merged, opts, g, mesh=dp_mesh)
        if not torch.equal(dp_img, img):
            raise RuntimeError(f"rays-DP {mode}: the first step's image differs")
        dp_first[mode] = dp_grads_check(f"rays-DP first step {mode}", got, want)
        if mode != "K3" and not float(got["factor_reflection"]) != 0.0:
            raise RuntimeError("the lit rays-DP step has no factor_reflection gradient")
        dp_train[mode] = (params, torch.optim.Adam(list(params.values()), lr=TRAIN_LR[mode]),
                          static_scene, target)
        dp_runs[mode] = (lambda p=params, o=dp_train[mode][1], sc=static_scene, t=target:
                         pallas_dp.train_step_fast_sharded(p, o, sc, opts, t, mesh=dp_mesh))
        del merged, img, g, want, got, dp_img
    torch.cuda.synchronize()
    cuda_march.reset_launch_counts()
    dp_losses = {mode: [float(step()) for _ in range(TRAIN_STEPS)]
                 for mode, step in dp_runs.items()}
    torch.cuda.synchronize()
    dp_train_launches = dict(cuda_march.LAUNCHES_BY_MODE)
    per_step = DP_MAIN_BANDS * TRAIN_STEPS
    expected = {k: per_step if k in ("K1", "K3", "K4", "K6", "K5", "K6L") else 0
                for k in dp_train_launches}
    if dp_train_launches != expected:
        raise RuntimeError(f"the rays-DP steps launched {dp_train_launches}, expected {expected}")
    for mode, values in dp_losses.items():
        if not (all(np.isfinite(values)) and all(b < a for a, b in zip(values, values[1:]))):
            raise RuntimeError(f"the rays-DP {mode} loss did not fall: {values}")

    # train_step_sharded (plain autograd per band) against train.train_step
    small = flagship(DP_SMALL["volume"], "K1", ab_aliased=False, noise=0.05)
    small_opts = small.options(DP_SMALL["image"], DP_SMALL["image"])
    small_target = render_forward_fast(small, small_opts)
    autograd_steps = {}
    for name, step in (("train_step", train.train_step),
                       ("train_step_sharded", functools.partial(train.train_step_sharded,
                                                                mesh=make_mesh(2)))):
        params, static_scene = train.split_params(small)
        with torch.no_grad():
            params["emission"].mul_(1.3).add_(0.05)
        optimizer = torch.optim.SGD(list(params.values()), lr=1e-3)
        loss = float(step(params, optimizer, static_scene, small_opts, small_target))
        autograd_steps[name] = (loss, {k: p.grad for k, p in params.items()})
    (l_one, g_one), (l_dp, g_dp) = autograd_steps.values()
    sharded_step = {"loss": [l_dp, l_one], "grads_err_of_scale": dp_grads_check(
        "train_step_sharded", g_dp, g_one)}
    if abs(l_dp - l_one) > 1e-5 * abs(l_one):
        raise RuntimeError(f"train_step_sharded's loss {l_dp} is not train_step's {l_one}")

    # the rows x bricks mesh: plain brick passes, 2 bands of 2 bricks
    lit_small = flagship(DP_SMALL["volume"], "K4", ab_aliased=False)
    lit_opts = lit_small.options(*DP_SMALL["brick_image"])
    mesh_2d_err = check("rows x bricks render",
                        bricks.render_forward_bricked(lit_small, lit_opts,
                                                      mesh=make_mesh_2d(2, 2)),
                        render_forward_fast(lit_small, lit_opts), *tol["K4"], None)
    del small, small_target, lit_small, autograd_steps, g_one, g_dp

    # times (CUDA events, warm, median of 5): the single launch, the DP path
    # (its bands on streams of their own), and its four band launches alone,
    # one after another on one stream; the host's time in both paths
    for mode, scene in dp_scenes.items():
        layout = sharding.bands(size, DP_MAIN_BANDS)

        def bands_alone(s=scene):
            packed = cuda_march.pack_lookup(s) if kernel_mode(s) == "K5" else None
            return [render_rows_fast(s, opts, 0.0, y0, rows, packed=packed)
                    for y0, rows in layout]

        dp_timing[f"{mode}_forward"] = {
            "single_ms": median_ms(lambda s=scene: render_forward_fast(s, opts))[0],
            "dp_ms": median_ms(lambda s=scene: pallas_dp.render_forward_fast_sharded(
                s, opts, mesh=dp_mesh))[0],
            "bands_one_stream_ms": median_ms(bands_alone)[0],
            "single_host_ms": host_ms(lambda s=scene: render_forward_fast(s, opts)),
            "dp_host_ms": host_ms(lambda s=scene: pallas_dp.render_forward_fast_sharded(
                s, opts, mesh=dp_mesh))}
    del dp_scenes, singles, dp_images
    for mode, (params, optimizer, static_scene, target) in dp_train.items():
        with torch.no_grad():  # the backward alone, from the step's forward image
            merged = train.merge_params(params, static_scene)
            img = render_forward_fast(merged, opts)
            g = 2.0 * (img - target)
            cell = {"single_backward_ms": median_ms(
                        lambda: voxel_grads_fast(merged, opts, g, image=img))[0],
                    "dp_backward_ms": median_ms(lambda: pallas_dp.voxel_grads_fast_sharded(
                        merged, opts, g, image=img, mesh=dp_mesh))[0]}
            del merged, img, g
        for name, step in (
                ("single", lambda: train.train_step_fast(params, optimizer, static_scene, opts,
                                                         target)),
                ("dp", lambda: pallas_dp.train_step_fast_sharded(
                    params, optimizer, static_scene, opts, target, mesh=dp_mesh))):
            cell[f"{name}_ms"] = median_ms(step)[0]
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step()
            torch.cuda.synchronize()
            cell[f"{name}_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        dp_timing[f"{mode}_step"] = cell
    record({"phase": "dp_main_path",
            "entry": ["render_forward_fast_sharded", "train_step_fast_sharded",
                      "train_step_sharded", "render_forward_bricked (rows x bricks)"],
            "volume": MAIN["volume"], "image": size, "bands": DP_MAIN_BANDS,
            "device": "every band on cuda:0", "render_launches": dp_render_launches,
            "k5_packs_a_render": packs[0], "train_launches": dp_train_launches,
            "steps": TRAIN_STEPS, "optimizer": "Adam", "lr": TRAIN_LR, "volume_noise": 0.05,
            "losses": dp_losses, "first_step_vs_single_of_scale": dp_first,
            "train_step_sharded_vs_train_step": {"volume": DP_SMALL["volume"],
                                                 "image": DP_SMALL["image"], "bands": 2,
                                                 "optimizer": "SGD", **sharded_step},
            "rows_x_bricks_2x2_vs_K4": {"volume": DP_SMALL["volume"],
                                        "image": DP_SMALL["brick_image"],
                                        "max_abs_err": mesh_2d_err},
            "ms": dp_timing, "seconds": time.perf_counter() - t_phase})
    del dp_train, dp_runs
    torch.cuda.empty_cache()

    # ---- 14. the slab sweep against the plain sweep and K1 at 128^3 / 256x192 --
    def on_host(scene):
        """``scene`` with every grid the march samples in pinned host memory,
        as the streamed tier takes them."""
        return scene.replace(**{k: getattr(scene, k).replace(
            data=getattr(scene, k).data.cpu().pin_memory())
            for k in ("emission", "absorption", "reflection", "gradient_x", "gradient_y",
                      "gradient_z") if getattr(scene, k) is not None})

    def ascending_share(scene, opts):
        rays = slab._Rays(scene, opts, 0.0, 0, opts.height)
        return float(((rays.dz() >= 0) & rays.hit).sum() / rays.hit.sum())

    def vs_plain_sweep(name, got, plain):
        """The kernels' sweep against the plain one. The plain sweep takes
        positions and t in closed form (the JAX package's), the kernels
        accumulate them, so about 5 % of the rays take one step more or less
        at the box's far side, where the shell is bright: allowed 2e-3 of
        the scale (measured on an H100 at most 6.1e-4, 4.6 % of the values
        beyond 1e-5 of it; the JAX package allows rtol=5e-3, atol=1e-4 for
        the same drift, tests/test_slab.py)."""
        scale = float(plain.abs().max())
        diff = (got - plain).abs()
        out = {"max_err_of_scale": float(diff.max()) / scale,
               "share_beyond_1e-5_of_scale": float((diff > 1e-5 * scale).float().mean())}
        if out["max_err_of_scale"] > 2e-3:
            raise RuntimeError(f"{name}: the kernels' sweep is off the plain sweep: {out}")
        return out

    t_phase = time.perf_counter()
    slab_cases = {}
    cw, ch = COMPARE["width"], COMPARE["height"]
    for name, rot, kw, vol, counts in (
            ("dz_positive", (10, 5, 0), {}, COMPARE["volume"], (4, 16)),
            ("dz_negative_aliased", (180, 20, 0), dict(ab_aliased=True), COMPARE["volume"],
             (4, 16)),
            ("dz_mixed", (88, 0, 0), {}, COMPARE["volume"], (4, 16)),
            ("one_row_slabs_d16", (88, 0, 0), {}, 16, (16,))):
        scene = brick_scene(vol, rot, **kw)
        host = on_host(scene)
        opts = scene.options(cw, ch)
        single = render_forward_fast(scene, opts)
        cell = {"volume": vol, "ascending_share": ascending_share(scene, opts)}
        for n in counts:
            slabbed = cuda_slab.render_forward_slabbed_fast(scene, opts, n_slabs=n)
            visited = cuda_slab.LAST_SWEEP.visited
            streamed = slab.render_forward_streamed(host, opts, n_slabs=n)
            stats = cuda_slab.LAST_SWEEP
            torch.cuda.synchronize()
            # the same kernels on the same windows: copies or views
            if not torch.equal(streamed, slabbed) or stats.visited != visited:
                raise RuntimeError(f"slab sweep {name}, {n} slabs: streamed and slabbed differ")
            cell[f"{n}_slabs"] = {
                "vs_K1_of_scale": of_scale(f"slab sweep {name} {n} slabs vs K1", slabbed, single),
                "streamed_equals_slabbed": True, "visited": visited,
                "h2d_bytes": stats.h2d_bytes}
            if n == counts[0]:  # the plain sweep (seconds at 16 slabs) at the first count
                plain, plain_ms = timed(lambda: slab.render_forward_slabbed(scene, opts,
                                                                            n_slabs=n))
                cell[f"{n}_slabs"].update(vs_plain_sweep=vs_plain_sweep(
                    f"slab sweep {name} {n} slabs", slabbed, plain), plain_ms=plain_ms)
        slab_cases[name] = cell
    signs = [slab_cases[k]["ascending_share"] for k in ("dz_positive", "dz_negative_aliased",
                                                         "dz_mixed")]
    if not (signs[0] == 1.0 and signs[1] == 0.0 and 0.05 < signs[2] < 0.95):
        raise RuntimeError(f"the cameras do not cover rising, falling and mixed rays: {signs}")
    # gradients of one slabbed and one streamed call against voxel_grads_fast
    # (phase 12's tolerance: grids 1e-5 of scale, other keys 1e-4)
    scene = brick_scene(COMPARE["volume"], (88, 0, 0))
    opts = scene.options(cw, ch)
    g = cotangent(ch, cw, seed=60)
    img_k, want = voxel_grads_fast(scene, opts, g)
    img_s, got_s = cuda_slab.voxel_grads_slabbed_fast(scene, opts, g, n_slabs=4)
    got_h, img_h = slab.streamed_grads(on_host(scene), opts, g, n_slabs=4)
    torch.cuda.synchronize()
    if not (torch.equal(img_s, img_h) and all(v.device.type == "cpu" for k, v in got_h.items()
                                              if k in ("emission", "absorption"))):
        raise RuntimeError("the streamed gradients' image or grids are not where they belong")
    slab_grads = {"slabbed": dp_grads_check("slabbed gradients", got_s, want),
                  "streamed": dp_grads_check("streamed gradients",
                                             {k: v.to(dev) for k, v in got_h.items()}, want),
                  "image_vs_K1_of_scale": of_scale("slab gradients' image", img_s, img_k)}
    del scene, got_s, got_h, want
    # lit scenes through the lit forms, 4 slabs: the on-the-fly scene with two
    # lights and rays of both signs of dz, and the lookup one; streamed equals
    # slabbed bit for bit, both within 1e-5 of scale of K4's or K5's image;
    # the on-the-fly scene's gradients of one slabbed and one streamed call
    # against voxel_grads_fast (K6) as above
    lit_slab = {}
    for name, mode, kw in (("otf_two_lights_dz_mixed", "K4",
                            dict(ab_aliased=False, n_lights=2, noise=0.05, rotate=(88, 0, 0))),
                           ("lookup", "K5", dict(ab_aliased=False))):
        lit = flagship(COMPARE["volume"], mode, **kw)
        lit_host = on_host(lit)
        lit_opts = lit.options(cw, ch)
        lit_single = render_forward_fast(lit, lit_opts)
        slabbed = cuda_slab.render_forward_slabbed_fast(lit, lit_opts, n_slabs=4)
        streamed = slab.render_forward_streamed(lit_host, lit_opts, n_slabs=4)
        torch.cuda.synchronize()
        if not torch.equal(streamed, slabbed):
            raise RuntimeError(f"lit slab sweep {name}: streamed and slabbed differ")
        cell = {"vs_single_device_kernel_of_scale": of_scale(
            f"lit slab sweep {name} vs {mode}", slabbed, lit_single),
            "streamed_equals_slabbed": True, "visited": cuda_slab.LAST_SWEEP.visited,
            "h2d_bytes": cuda_slab.LAST_SWEEP.h2d_bytes}
        if mode == "K4":
            g = cotangent(ch, cw, seed=61)
            img_k, want = voxel_grads_fast(lit, lit_opts, g)
            img_s, got_s = cuda_slab.voxel_grads_slabbed_fast(lit, lit_opts, g, n_slabs=4)
            got_h, img_h = slab.streamed_grads(lit_host, lit_opts, g, n_slabs=4)
            torch.cuda.synchronize()
            if not torch.equal(img_s, img_h):
                raise RuntimeError("the lit streamed gradients' image differs from the slabbed")
            cell["grads_vs_voxel_grads_fast"] = {
                "slabbed": dp_grads_check("lit slabbed gradients", got_s, want),
                "streamed": dp_grads_check("lit streamed gradients",
                                           {k: v.to(dev) for k, v in got_h.items()}, want)}
        lit_slab[name] = cell
        del lit, lit_host, lit_single
    record({"phase": "slab_vs_plain", "volume": COMPARE["volume"], "image": [cw, ch],
            "volume_noise": 0.05, "cases": slab_cases,
            "tolerance": {"vs_K1_of_scale": 1e-5, "vs_plain_sweep_of_scale": 2e-3,
                          "grads_of_scale": {"grids": BRICK_GRAD_TOL, "others": GRAD_TOL}},
            "grads_dz_mixed_4_slabs_vs_voxel_grads_fast": slab_grads,
            "lit_4_slabs": lit_slab,
            "seconds": time.perf_counter() - t_phase})
    del host, single, plain, slabbed, streamed
    torch.cuda.empty_cache()

    # ---- 15. the slab main path: the planned facade and training steps ----------
    t_phase = time.perf_counter()
    K7_FORM_KEYS = ("K7_transmittance", "K7_segment", "K7_scatter")

    def counted(fn):
        """``fn()`` with the launch counts set to 0 just before and read just
        after; (result, counts)."""
        torch.cuda.synchronize()
        cuda_march.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(cuda_march.LAUNCHES_BY_MODE)

    def peak_of(fn):
        """``fn()`` and the device memory it allocated at its peak above what
        was allocated before it."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    def k7_only(name, launches, forms):
        """Raises unless the launches are K7's ``forms`` alone."""
        other = {k: v for k, v in launches.items() if v and k not in forms}
        if other or not all(launches[k] for k in forms):
            raise RuntimeError(f"{name} launched {launches}, expected {forms} alone")

    def sweep_launches(stats):
        return sum(len(v) for v in stats.visited)

    # (a) the streamed facade at 512^3 / 1024^2: 1 GiB of host grids
    nb, ib = BIG["volume"], BIG["image"]
    em_dev = shell(nb)
    ramp = torch.linspace(0.5, 1.0, nb, device=dev)[None, None, :]
    host_em, host_ab = em_dev.cpu(), (em_dev * ramp).cpu()
    del em_dev

    def big_facade():
        r = VolumeRenderer()
        r.volume_emission = Volume.create(host_em, device="cpu")
        r.volume_absorption = Volume.create(host_ab, device="cpu")
        r.factor_absorption, r.factor_reflection, r.color = 0.6, 0.4, (1.0, 0.9, 0.8)
        r.focal_length, r.distance_to_object = 3.0, 6.0
        r.rotate(125, 25, 0)
        r.image_resolution = (ib, ib)
        return r

    r = big_facade()
    big_scene = r._build_scene(resident=False)
    big_opts = big_scene.options(ib, ib)
    vol_bytes = planner.scene_volume_bytes(big_scene)
    est8 = planner.tier_bytes(big_scene, big_opts, "streamed", n_slabs=8)
    r.memory_budget_bytes = int(est8 / 0.7) + 1
    if not r.memory_budget_bytes < vol_bytes:
        raise RuntimeError("the streamed budget is not below the volumes")
    r.render()  # the content hashes and the pinned host copies, kept by the renderer
    (img_stream, stream_launches), stream_peak = peak_of(lambda: counted(r.render))
    plan, stats = r.last_plan, cuda_slab.LAST_SWEEP
    if not (plan.path == "streamed" and plan.n_slabs >= 8
            and stream_peak <= plan.est_bytes <= plan.budget_bytes <= r.memory_budget_bytes):
        raise RuntimeError(f"streamed facade: {plan}, peak {stream_peak / 2 ** 20:.1f} MiB")
    visited = sweep_launches(stats)
    k7_only("the streamed facade render", stream_launches, K7_FORM_KEYS[:2])
    if not (stream_launches["K7_transmittance"] == stream_launches["K7_segment"] == visited
            <= 2 * plan.n_slabs):
        raise RuntimeError(f"streamed facade: {stream_launches} for {stats.visited}")
    h2d_ms = stats.h2d_ms()
    dev_scene = r._build_scene()
    flat_big = render_forward_fast(dev_scene, big_opts)
    streamed_facade = {
        "plan": str(plan), "n_slabs": plan.n_slabs, "est_bytes": plan.est_bytes,
        "budget_bytes": r.memory_budget_bytes, "budget_after_headroom": plan.budget_bytes,
        "volume_bytes": vol_bytes, "peak_bytes": stream_peak, "launches": stream_launches,
        "visited": stats.visited, "h2d_bytes": stats.h2d_bytes, "h2d_ms": h2d_ms,
        "h2d_GB_per_s": stats.h2d_bytes / (h2d_ms * 1e-3) / 1e9,
        "vs_K1_of_scale": of_scale("streamed facade vs K1", img_stream, flat_big),
        "nonzero_frac": float((img_stream.amax(-1) > 0).float().mean())}
    slab_timing = {f"streamed_render_{nb}_{ib}": {
        "ms": median_ms(r.render)[0], "host_ms": host_ms(r.render),
        "flat_K1_ms": median_ms(lambda: render_forward_fast(dev_scene, big_opts))[0]}}
    del r, dev_scene, flat_big, img_stream, big_scene, host_em, host_ab
    torch.cuda.empty_cache()

    # (b) the slabbed sweep at 256^3 / 512^2 against its estimate; the
    # planner's pick at that budget
    scene = brick_scene(MAIN["volume"], (125, 25, 0))  # the noisy K3 scene
    opts = scene.options(size, size)
    single = render_forward_fast(scene, opts)
    n_main = 8
    est_slabbed = planner.tier_bytes(scene, opts, "slabbed", n_slabs=n_main)
    (img_slabbed, slabbed_launches), slabbed_peak = peak_of(lambda: counted(
        lambda: cuda_slab.render_forward_slabbed_fast(scene, opts, n_slabs=n_main)))
    grids = planner.scene_volume_bytes(scene)  # the views' grids, on the card before
    k7_only("the slabbed render", slabbed_launches, K7_FORM_KEYS[:2])
    if not (slabbed_launches["K7_segment"] == sweep_launches(cuda_slab.LAST_SWEEP)
            and slabbed_peak + grids <= est_slabbed):
        raise RuntimeError(f"slabbed: {slabbed_launches}, peak {slabbed_peak} + {grids} "
                           f"over {est_slabbed}")
    slabbed_budget = int(est_slabbed / 0.7) + 1
    slabbed_main = {
        "n_slabs": n_main, "est_bytes": est_slabbed, "budget_bytes": slabbed_budget,
        "peak_bytes_with_grids": slabbed_peak + grids, "launches": slabbed_launches,
        "visited": cuda_slab.LAST_SWEEP.visited,
        "planner_pick_at_this_budget": str(planner.plan_render(scene, opts,
                                                               budget_bytes=slabbed_budget)),
        "vs_K1_of_scale": of_scale("slabbed vs K1", img_slabbed, single)}
    slab_timing[f"slabbed_render_{MAIN['volume']}_{size}"] = {
        "ms": median_ms(lambda: cuda_slab.render_forward_slabbed_fast(
            scene, opts, n_slabs=n_main))[0],
        "host_ms": host_ms(lambda: cuda_slab.render_forward_slabbed_fast(
            scene, opts, n_slabs=n_main)),
        "flat_K1_ms": median_ms(lambda: render_forward_fast(scene, opts))[0]}

    # (c) training at 256^3 / 512^2 on the noisy K3 scene: three Adam steps of
    # train_step_streamed and of train_step_planned (streamed), the grids in
    # pinned host memory; the first step's gradients against voxel_grads_fast
    dev_params, static = train.split_params(scene)
    with torch.no_grad():
        dev_params["emission"].mul_(1.3).add_(0.05)
        merged = train.merge_params(dev_params, static)
        img0 = render_forward_fast(merged, opts)
        _, want0 = voxel_grads_fast(merged, opts, 2.0 * (img0 - single), image=img0)
        del merged, img0

    def host_params():
        return {k: v.detach().cpu().pin_memory().requires_grad_(True)
                for k, v in dev_params.items()}

    def adam(params):
        return torch.optim.Adam(list(params.values()), lr=TRAIN_LR["K3"])

    train_cells = {}
    for name in ("train_step_streamed", "train_step_planned_streamed"):
        params = host_params()
        optimizer = adam(params)
        if name == "train_step_streamed":
            def step(p=params, o=optimizer):
                return train.train_step_streamed(p, o, static, opts, single, n_slabs=n_main), None
        else:
            est = planner.tier_bytes(train.merge_params(params, static), opts, "streamed",
                                     n_slabs=n_main, training=True, optimizer=optimizer)

            def step(p=params, o=optimizer, budget=int(est / 0.7) + 1):
                return train.train_step_planned(p, o, static, opts, single, budget_bytes=budget)
        (loss, plan), step_launches = counted(step)
        first_grads = {k: p.grad.to(dev) for k, p in params.items()}
        losses = [float(loss)]
        rest, rest_launches = counted(lambda: [step()[0] for _ in range(TRAIN_STEPS - 1)])
        losses += [float(x) for x in rest]
        if not (all(np.isfinite(losses)) and all(b < a for a, b in zip(losses, losses[1:]))):
            raise RuntimeError(f"{name}: the loss did not fall: {losses}")
        if plan is not None and (plan.path, plan.n_slabs) != ("streamed", n_main):
            raise RuntimeError(f"{name} planned {plan}")
        k7_only(name, step_launches, K7_FORM_KEYS)
        train_cells[name] = {
            "losses": losses, "plan": None if plan is None else str(plan),
            "first_step_launches": step_launches,
            "launches": {k: step_launches[k] + rest_launches[k] for k in step_launches},
            "first_step_vs_voxel_grads_fast_of_scale": dp_grads_check(
                f"{name} first step", first_grads, want0)}
    # train_step_planned without a budget: the kernels on the whole grids
    params = {k: v.detach().clone().requires_grad_(True) for k, v in dev_params.items()}
    (cuda_loss, cuda_plan), cuda_launches = counted(lambda: train.train_step_planned(
        params, adam(params), static, opts, single))
    if cuda_plan.path != "cuda" or {k: v for k, v in cuda_launches.items() if v} != {
            "K1": 1, "K3": 1}:
        raise RuntimeError(f"train_step_planned without a budget: {cuda_plan}, {cuda_launches}")
    train_cells["train_step_planned_no_budget"] = {"plan": str(cuda_plan),
                                                   "launches": cuda_launches,
                                                   "loss": float(cuda_loss)}
    # the step times, CUDA events, warm, median of 5
    for name, make in (
            ("train_step_streamed", lambda p, o: train.train_step_streamed(
                p, o, static, opts, single, n_slabs=n_main)),
            ("train_step_slabbed", lambda p, o: train.train_step_slabbed(
                p, o, static, opts, single, n_slabs=n_main)),
            ("train_step_fast", lambda p, o: train.train_step_fast(p, o, static, opts, single))):
        params = (host_params() if name == "train_step_streamed" else
                  {k: v.detach().clone().requires_grad_(True) for k, v in dev_params.items()})
        optimizer = adam(params)
        slab_timing[f"{name}_{MAIN['volume']}_{size}"] = {
            "ms": median_ms(lambda: make(params, optimizer))[0],
            "host_ms": host_ms(lambda: make(params, optimizer))}
    del params, dev_params, want0, first_grads

    # (c2) lit scenes at 256^3 / 512^2. The facade under a budget below the
    # whole-grid tier: the K4 scene planned streamed, the K5 scene slabbed
    # (the sweep saves K5's pack), counted: K7 phase 1 and lit phase 2 alone,
    # the image within 1e-5 of scale of the kernel's, the peak within the
    # plan's estimate. Then one Adam step each of train_step_streamed,
    # train_step_slabbed and train_step_planned (streamed) on the noisy K4
    # scene: loss and gradients against train_step_fast's (K4 + K6).
    lit_facade = {}
    lit_launches = {}
    for mode in ("K4", "K5"):
        em = shell(MAIN["volume"])
        r = VolumeRenderer()
        r.volume_emission = Volume.create(em)
        r.volume_absorption = Volume.create(em * 0.8)
        r.volume_reflection = Volume.create(em * 0.5)
        r.volume_illumination = henyey_greenstein_lut(32)
        r.light_sources = [LightSource([2.0, 3.0, -1.5], [1.0, 1.0, 1.0])]
        if mode == "K5":
            r.volume_gradient_x, r.volume_gradient_y, r.volume_gradient_z = (
                Volume.create(em).gradient_volumes())
        r.factor_absorption, r.factor_reflection, r.color = 0.6, 0.4, (1.0, 0.9, 0.8)
        r.focal_length, r.distance_to_object = 3.0, 6.0
        r.rotate(125, 25, 0)
        r.image_resolution = (size, size)
        lscene = r._build_scene()
        want = render_forward_fast(lscene, opts)
        r.memory_budget_bytes = int((planner.tier_bytes(lscene, opts, "cuda") - 1) / 0.7)
        r.render()  # the content hashes and, streamed, the pinned host copies
        grids = planner.scene_volume_bytes(lscene)
        (img, counts), peak = peak_of(lambda: counted(r.render))
        plan = r.last_plan
        k7_only(f"the lit {mode} facade render", counts, ("K7_transmittance", "K7_segment_lit"))
        resident = grids if plan.path == "slabbed" else 0  # the views' grids, there before
        if not (plan.path == ("streamed" if mode == "K4" else "slabbed")
                and counts["K7_transmittance"] == counts["K7_segment_lit"]
                and peak + resident <= plan.est_bytes <= plan.budget_bytes):
            raise RuntimeError(f"lit {mode} facade: {plan}, {counts}, peak {peak}")
        lit_launches[f"{plan.path}_facade_render_{mode}"] = counts
        lit_facade[mode] = {
            "plan": str(plan), "est_bytes": plan.est_bytes, "peak_bytes": peak + resident,
            "launches": counts, "visited": cuda_slab.LAST_SWEEP.visited,
            "h2d_bytes": cuda_slab.LAST_SWEEP.h2d_bytes,
            "vs_kernel_of_scale": of_scale(f"lit {mode} facade vs {mode}", img, want),
            "ms": median_ms(r.render)[0], "host_ms": host_ms(r.render),
            f"flat_{mode}_ms": median_ms(lambda: render_forward_fast(lscene, opts))[0]}
        del r, lscene, want, img, em
        torch.cuda.empty_cache()

    lit = flagship(MAIN["volume"], "K4", ab_aliased=False, noise=0.05)
    lit_target = render_forward_fast(lit, opts)
    lit_dev_params, lit_static = train.split_params(lit)
    # the streamed steps take every grid from host memory, reflection too
    lit_host_static = lit_static.replace(reflection=lit_static.reflection.replace(
        data=lit_static.reflection.data.cpu().pin_memory()))
    with torch.no_grad():
        lit_dev_params["emission"].mul_(1.3).add_(0.05)
        # A sweep step's cotangent comes from the sweep's own image, which
        # sums the slabs' contributions and differs from K4's in the last
        # bits; the lit normals carry that into the emission gradient. So its
        # gradients are held against K6's for the sweep image's cotangent.
        merged = train.merge_params(lit_dev_params, lit_static)
        img_k4 = render_forward_fast(merged, opts)
        img_sweep = cuda_slab.render_forward_slabbed_fast(merged, opts, n_slabs=n_main)
        _, want_sweep = voxel_grads_fast(merged, opts, 2.0 * (img_sweep - lit_target),
                                         image=img_k4)
        want_sweep_loss = float(torch.sum((img_sweep - lit_target) ** 2))
        sweep_image_vs_k4 = of_scale("the lit sweep image vs K4", img_sweep, img_k4)
        del merged, img_k4, img_sweep

    def lit_params(host):
        return {k: (v.detach().cpu().pin_memory() if host else v.detach().clone())
                .requires_grad_(True) for k, v in lit_dev_params.items()}

    def lit_adam(params):
        return torch.optim.Adam(list(params.values()), lr=TRAIN_LR["K6"])

    lit_steps = {
        "train_step_fast": (False, lambda p, o: (train.train_step_fast(
            p, o, lit_static, opts, lit_target), None)),
        "train_step_streamed": (True, lambda p, o: (train.train_step_streamed(
            p, o, lit_host_static, opts, lit_target, n_slabs=n_main), None)),
        "train_step_slabbed": (False, lambda p, o: (train.train_step_slabbed(
            p, o, lit_static, opts, lit_target, n_slabs=n_main), None)),
        "train_step_planned_streamed": (True, lambda p, o: train.train_step_planned(
            p, o, lit_host_static, opts, lit_target, budget_bytes=int(planner.tier_bytes(
                train.merge_params(p, lit_host_static), opts, "streamed", n_slabs=n_main,
                training=True, optimizer=o) / 0.7) + 1))}
    lit_train = {}
    for name, (host, step) in lit_steps.items():
        params = lit_params(host)
        optimizer = lit_adam(params)
        (loss, plan), counts = counted(lambda: step(params, optimizer))
        grads = {k: p.grad.to(dev) for k, p in params.items()}
        cell = {"loss": float(loss), "plan": None if plan is None else str(plan),
                "launches": counts}
        if name == "train_step_fast":
            want_loss, want_grads = float(loss), grads
            if {k: v for k, v in counts.items() if v} != {"K4": 1, "K6": 1}:
                raise RuntimeError(f"the lit train_step_fast launched {counts}")
        else:
            k7_only(name, counts, ("K7_transmittance", "K7_segment_lit", "K7_scatter_lit"))
            if plan is not None and (plan.path, plan.n_slabs) != ("streamed", n_main):
                raise RuntimeError(f"{name} planned {plan}")
            cell["loss_vs_train_step_fast_of_it"] = abs(float(loss) - want_loss) / want_loss
            cell["loss_vs_sweep_image_of_it"] = (abs(float(loss) - want_sweep_loss)
                                                 / want_sweep_loss)
            if cell["loss_vs_train_step_fast_of_it"] > 1e-4 or cell[
                    "loss_vs_sweep_image_of_it"] > 1e-6:
                raise RuntimeError(f"lit {name}: loss {float(loss)} against {want_loss} "
                                   f"(K4) and {want_sweep_loss} (the sweep's image)")
            cell["grads_vs_K6_same_cotangent_of_scale"] = dp_grads_check(
                f"lit {name} first step", grads, {k: want_sweep[k] for k in grads})
            cell["grads_vs_train_step_fast_of_scale"] = check_grads(
                f"lit {name} first step against train_step_fast", grads, want_grads, None,
                keys=want_grads.keys())
            lit_launches[f"lit_{name}"] = counts
        cell["ms"] = median_ms(lambda: step(params, optimizer))[0]
        cell["host_ms"] = host_ms(lambda: step(params, optimizer))
        lit_train[name] = cell
    del lit, lit_target, lit_dev_params, lit_static, lit_host_static, params, optimizer, grads
    del want_grads, want_sweep
    torch.cuda.empty_cache()

    # (c3) the lookup scene (K5's, 5 % seeded noise): one Adam step each of
    # train_step_fast (K5 + K6L), train_step_streamed and train_step_slabbed
    # (the lookup gradient segment a slab), counted; the sweeps' loss and
    # gradients against K6L's for the cotangent of the sweep's own image (as
    # above); each step timed, and its peak device memory above what was
    # allocated before it held within the planner's estimate of its tier
    look = flagship(MAIN["volume"], "K5", ab_aliased=False, noise=0.05)
    look_target = render_forward_fast(look, opts)
    look_dev_params, look_static = train.split_params(look)
    look_host_static = look_static.replace(**{
        k: getattr(look_static, k).replace(data=getattr(look_static, k).data.cpu().pin_memory())
        for k in ("reflection", "gradient_x", "gradient_y", "gradient_z")})
    with torch.no_grad():
        look_dev_params["emission"].mul_(1.3).add_(0.05)
        merged = train.merge_params(look_dev_params, look_static)
        img_sweep = cuda_slab.render_forward_slabbed_fast(merged, opts, n_slabs=n_main)
        _, want_look = voxel_grads_fast(merged, opts, 2.0 * (img_sweep - look_target))
        want_look_loss = float(torch.sum((img_sweep - look_target) ** 2))
        del merged, img_sweep
    def look_planned(p, o):
        """train_step_planned under the budget of the streamed tier's
        estimate (the headroom taken off): the streamed sweep, n_main slabs."""
        loss, plan = train.train_step_planned(
            p, o, look_host_static, opts, look_target, budget_bytes=int(planner.tier_bytes(
                train.merge_params(p, look_host_static), opts, "streamed", n_slabs=n_main,
                training=True, optimizer=o) / 0.7) + 1)
        if (plan.path, plan.n_slabs) != ("streamed", n_main):
            raise RuntimeError(f"the lookup planned step took {plan}")
        return loss

    look_steps = {
        "train_step_fast": (False, "cuda", lambda p, o: train.train_step_fast(
            p, o, look_static, opts, look_target)),
        "train_step_streamed": (True, "streamed", lambda p, o: train.train_step_streamed(
            p, o, look_host_static, opts, look_target, n_slabs=n_main)),
        "train_step_slabbed": (False, "slabbed", lambda p, o: train.train_step_slabbed(
            p, o, look_static, opts, look_target, n_slabs=n_main)),
        "train_step_planned_streamed": (True, "streamed", look_planned)}
    lookup_train = {}
    for name, (host, tier, step) in look_steps.items():
        params = {k: (v.detach().cpu().pin_memory() if host else v.detach().clone())
                  .requires_grad_(True) for k, v in look_dev_params.items()}
        optimizer = torch.optim.Adam(list(params.values()), lr=TRAIN_LR["K6L"])
        est = planner.tier_bytes(
            train.merge_params(params, look_host_static if host else look_static), opts, tier,
            n_slabs=n_main, training=True, optimizer=optimizer)
        (loss, counts), peak = peak_of(lambda: counted(lambda: step(params, optimizer)))
        grads = {k: p.grad.to(dev) for k, p in params.items()}
        cell = {"loss": float(loss), "launches": counts, "tier": tier,
                "peak_bytes": peak, "tier_bytes": est}
        if peak > est:  # what the step allocated above its start, in the tier's estimate
            raise RuntimeError(f"the lookup {name} took {peak / 2 ** 20:.1f} MiB at its peak, "
                               f"more than its tier's estimate, {est / 2 ** 20:.1f} MiB")
        if name == "train_step_fast":
            if {k: v for k, v in counts.items() if v} != {"K5": 1, "K6L": 1}:
                raise RuntimeError(f"the lookup train_step_fast launched {counts}")
        else:
            k7_only(f"lookup {name}", counts,
                    ("K7_transmittance", "K7_segment_lit", "K7_scatter_lookup"))
            cell["loss_vs_sweep_image_of_it"] = abs(float(loss) - want_look_loss) / want_look_loss
            if cell["loss_vs_sweep_image_of_it"] > 1e-6:
                raise RuntimeError(f"lookup {name}: loss {float(loss)} against "
                                   f"{want_look_loss} (the sweep's image)")
            cell["grads_vs_K6L_same_cotangent_of_scale"] = dp_grads_check(
                f"lookup {name} first step", grads, {k: want_look[k] for k in grads})
            lit_launches[f"lookup_{name}"] = counts
        cell["ms"] = median_ms(lambda: step(params, optimizer))[0]
        cell["host_ms"] = host_ms(lambda: step(params, optimizer))
        lookup_train[name] = cell
    del look, look_target, look_dev_params, look_static, look_host_static, params, optimizer
    del grads, want_look
    torch.cuda.empty_cache()

    # (d) the facade with make_mesh(4) on the one card: rays-DP, and bricks
    # under a budget that the whole grids do not fit
    em = shell(MAIN["volume"])
    ramp = torch.linspace(0.5, 1.0, MAIN["volume"], device=dev)[None, None, :]
    r = VolumeRenderer()
    r.volume_emission, r.volume_absorption = Volume.create(em), Volume.create(em * ramp)
    r.factor_absorption, r.factor_reflection, r.color = 0.6, 0.4, (1.0, 0.9, 0.8)
    r.focal_length, r.distance_to_object = 3.0, 6.0
    r.rotate(125, 25, 0)
    r.image_resolution = (size, size)
    mesh_scene = r._build_scene()
    mesh_single = render_forward_fast(mesh_scene, opts)
    r.mesh = make_mesh(DP_MAIN_BANDS)
    img_dp, dp_launches = counted(r.render)
    dp_plan = r.last_plan
    if dp_plan.path != "cuda_dp" or not torch.equal(img_dp, mesh_single):
        raise RuntimeError(f"the facade with a mesh planned {dp_plan}, or its image differs")
    r.memory_budget_bytes = int(planner.tier_bytes(mesh_scene, opts, "bricked",
                                                   n_devices=DP_MAIN_BANDS) / 0.7) + 1
    img_bricked, bricked_launches = counted(r.render)
    bricked_plan = r.last_plan
    if bricked_plan.path != "bricked":
        raise RuntimeError(f"the facade's bricked budget planned {bricked_plan}")
    k7_only("the bricked facade render", bricked_launches, K7_FORM_KEYS[:2])
    mesh_facade = {
        "cuda_dp": {"plan": str(dp_plan), "launches": dp_launches, "bit_equal_to_K1": True},
        "bricked": {"plan": str(bricked_plan), "launches": bricked_launches,
                    "vs_K1": image_tolerance("bricked facade vs K1", img_bricked, mesh_single)}}
    del r, mesh_scene, mesh_single, img_dp, img_bricked, em, scene, single, img_slabbed
    torch.cuda.empty_cache()
    slab_launches = {
        "streamed_render": {k: stream_launches[k] for k in K7_FORM_KEYS},
        "slabbed_render": {k: slabbed_launches[k] for k in K7_FORM_KEYS},
        **{name: train_cells[name]["launches"] for name in ("train_step_streamed",
                                                              "train_step_planned_streamed")},
        "bricked_facade_render": {k: bricked_launches[k] for k in K7_FORM_KEYS}}
    record({"phase": "slab_main_path",
            "entry": ["VolumeRenderer.render (streamed, cuda_dp, bricked; lit streamed and "
                      "slabbed)", "render_forward_slabbed_fast", "train_step_streamed",
                      "train_step_planned", "train_step_slabbed (timed; lit counted)"],
            "nvidia_smi": smi_line, "streamed_facade": streamed_facade,
            "slabbed": slabbed_main, "training": train_cells, "mesh_facade": mesh_facade,
            "lit_facade": lit_facade, "lit_training": lit_train, "lookup_training": lookup_train,
            "lit_sweep_image_vs_K4_of_scale": sweep_image_vs_k4,
            "steps": TRAIN_STEPS, "optimizer": "Adam", "lr": TRAIN_LR["K3"],
            "volume_noise": 0.05, "ms": slab_timing, "seconds": time.perf_counter() - t_phase})

    # ---- 16-18. camera gradients, the oracle, utils -----------------------
    ctx = argparse.Namespace(dev=dev, MAIN=MAIN, COMPARE=COMPARE, shell=shell, flagship=flagship,
                             timed=timed, median_ms=median_ms, host_ms=host_ms, check=check)
    for name, run in (
            ("camera_grads", lambda: camera_grads_phase(ctx)),
            ("oracle_vs_kernels", lambda: oracle_phase(ctx)),
            ("utils", lambda: utils_phase(ctx, os.path.join(REPO, "out", "chip_smoke", "trace"),
                                          os.path.join(REPO, "out", "chip_smoke")))):
        record({"phase": name, "nvidia_smi": smi_line, **run()})
        torch.cuda.empty_cache()

    # ---- 19. the multi-process path over torch.distributed -----------------
    # multihost.run_demo on the card: a one-rank NCCL world, and two ranks
    # over gloo on the one card's tensors (NCCL puts no two ranks on one
    # card). Each rank renders the lit flagship scene rays-DP and takes one
    # Adam step of the plain and of the kernel DP step; every rank's image,
    # losses and gradients against the single-process render_forward_fast,
    # train.train_step_sharded and train_step_fast_sharded on as many bands
    # of the one card (the kernels' grids within 1e-5 of scale, other keys
    # GRAD_TOL: atomic adds land in no fixed order), and the ranks' launch
    # counts (K4 for the render and the steps, K6 for the kernel step).
    from volume_renderer_tpu_torch.parallel import multihost
    from volume_renderer_tpu_torch.utils import scaling_probe

    t_phase = time.perf_counter()
    multi = {}
    mp_scene, mp_opts, mp_target, mp_start = multihost.demo_problem(dev)
    mp_image = render_forward_fast(mp_scene, mp_opts)
    worlds = ((1, "nccl"), (2, "gloo"))
    brick_worlds = tuple((ranks, backend, multihost.FULL if full else multihost.BrickDemo(),
                          bands) for ranks, backend, full, bands in BRICK_WORLDS)
    # every rehearsal at once, each in processes of its own: rays-DP and
    # bricked in the small worlds, and the bricked ones at full width (1 x 4
    # and 2 x 2), which share the card with each other and the small worlds
    with concurrent.futures.ThreadPoolExecutor(len(worlds) + len(brick_worlds)) as pool:
        started = {world: (time.perf_counter(), pool.submit(
            multihost.run_demo, world[0], "cuda", world[1], 300.0)) for world in worlds}
        started.update({world: (time.perf_counter(), pool.submit(
            multihost.run_demo, world[0], "cuda", world[1], 300.0, bricks=world[2],
            bands=world[3])) for world in brick_worlds})
        rehearsals = {world: (future.result(), time.perf_counter() - t0)
                      for world, (t0, future) in started.items()}
    for ranks, backend in worlds:
        results, seconds = rehearsals[(ranks, backend)]
        want = {}
        for name, step in (("plain", train.train_step_sharded),
                           ("fast", pallas_dp.train_step_fast_sharded)):
            params = {k: v.detach().clone().requires_grad_(True) for k, v in mp_start.items()}
            optimizer = torch.optim.Adam(list(params.values()), lr=multihost.DEMO["lr"])
            loss = step(params, optimizer, mp_scene, mp_opts, mp_target, mesh=make_mesh(ranks))
            want[name] = (float(loss), {k: p.grad for k, p in params.items()})
        cell = {"backend": backend, "mesh": results[0]["mesh"], "seconds": seconds,
                "rank_launches": [{k: v for k, v in r["launches"].items() if v}
                                  for r in results]}
        for r in results:
            if r["backend"] != backend or not torch.equal(r["image"].to(dev), mp_image):
                raise RuntimeError(f"rank {r['rank']} of {ranks} ({backend}): its image is not "
                                   "render_forward_fast's")
            if not (r["launches"]["K4"] and r["launches"]["K6"]):
                raise RuntimeError(f"rank {r['rank']} of {ranks} launched {r['launches']}")
            for name, (want_loss, want_grads) in want.items():
                loss_err = abs(r[name]["loss"] - want_loss) / want_loss
                if loss_err > 1e-6:
                    raise RuntimeError(f"rank {r['rank']} of {ranks} ({backend}) {name} step: "
                                       f"loss {r[name]['loss']} against {want_loss}")
                errs = dp_grads_check(f"rank {r['rank']} of {ranks} {name} step",
                                      {k: v.to(dev) for k, v in r[name]["grads"].items()},
                                      want_grads)
                cell.setdefault(name, []).append({"loss": r[name]["loss"],
                                                  "loss_err_of_it": loss_err,
                                                  "grads_err_of_scale": errs})
        multi[f"{ranks}_{backend}"] = cell
    bricked_multi = bricked_rehearsal_cells(
        ctx, {world: rehearsals[world] for world in brick_worlds})
    record({"phase": "multi_process", "nvidia_smi": smi_line,
            "scene": f"lit flagship {multihost.DEMO['volume']}^3, "
                     f"{multihost.DEMO['width']}x{multihost.DEMO['height']}",
            "against": ["render_forward_fast", "train.train_step_sharded",
                        "train_step_fast_sharded"],
            **multi,
            "bricked": {"scene": "the flagship shell, unlit, lit and lit lookup "
                                 "(multihost.brick_demo_cases; 5 % seeded noise at 256^3)",
                        "against": ["render_forward_bricked_fast", "voxel_grads_bricked_fast",
                                    "train_step_fast_bricked on make_mesh(ranks)"],
                        **bricked_multi},
            "seconds": time.perf_counter() - t_phase})
    torch.cuda.empty_cache()

    # ---- 20. the scaling probe on the card ----------------------------------
    # The device time of the rays-DP and the bricked render, 8 bands and 8
    # bricks against 1, all on the one card at 256^3 / 512^2: one card's
    # total-work overhead of the sharded formulations, not a scaling
    # measurement.
    t_phase = time.perf_counter()
    record({"phase": "scaling_probe", "nvidia_smi": smi_line,
            **scaling_probe.measure(dev, MAIN["volume"], MAIN["image"], reps=3),
            "seconds": time.perf_counter() - t_phase})
    torch.cuda.empty_cache()

    # ---- 21. the examples ---------------------------------------------------
    t_phase = time.perf_counter()
    record({"phase": "examples", "nvidia_smi": smi_line,
            **examples_phase(ctx, os.path.join(REPO, "out", "chip_smoke", "examples")),
            "seconds": time.perf_counter() - t_phase})

    # ---- kernels line and the result ------------------------------------
    def rank_launches(mode):
        """Each rank's launches of ``mode`` in each bricked world (render and
        step, summed over the cases)."""
        return {name: [sum(counts.get(mode, 0) for counts in per_rank)
                       for per_rank in zip(*(cell[case]["rank_launches"] for case in BRICK_FORMS))]
                for name, cell in bricked_multi.items()}

    kernels = []
    for mode, what in (("K1", "unlit"), ("K4", "lit, on-the-fly gradients"),
                       ("K5", "lit, lookup gradients")):
        cell = cells[f"{mode}_{MAIN['volume']}_{MAIN['image']}"]
        kernels.append({
            "name": f"march_fwd[{mode}]", "route": "cuda",
            "source": "volume_renderer_tpu_torch/csrc/march_fwd.cu",
            "replaces": "volume_renderer_tpu/ops/pallas_march.py:688",
            "launches": launches[mode], "max_abs_err": max_err[mode],
            "dp_launches": dp_render_launches[mode],
            "dp_forward_ms": dp_timing[f"{mode}_forward"]["dp_ms"],
            "ms": cell["ms"], "plain_ms": cell["plain_ms"], "plain_cell": cell["plain_cell"],
            "bound_ms": cell["bound_ms"], "bound_by": cell["bound_by"], "library_ms": None,
            "mode": what, "cell": f"{MAIN['volume']}^3 volume, {MAIN['image']}^2 image",
            "ms_big": cells.get(f"{mode}_{BIG['volume']}_{BIG['image']}", {}).get("ms"),
            **({"pack_ms": cell["pack_ms"]} if "pack_ms" in cell else {}),
        })
    for mode, what in (("K2", "transfer-parameter replay"), ("K3", "voxel-gradient scatter"),
                       ("K6", "lit voxel-gradient scatter")):
        cell = cells[f"{mode}_{MAIN['volume']}_{MAIN['image']}"]
        kernels.append({
            "name": f"march_bwd[{mode}]", "route": "cuda",
            "source": "volume_renderer_tpu_torch/csrc/march_bwd.cu",
            "replaces": "volume_renderer_tpu/ops/pallas_march.py:688",
            "launches": train_launches[mode], "max_abs_err": grad_abs_err[mode],
            "dp_launches": dp_train_launches[mode],
            "max_err_of_scale": grad_err[mode],
            "ms": cell["ms"], "plain_ms": cell["plain_ms"], "plain_rows": cell["plain_rows"],
            "bound_ms": cell["bound_ms"], "bound_by": cell["bound_by"], "library_ms": None,
            "fwd_bwd_ms": cell["fwd_bwd_ms"], "train_step_ms": cell["train_step_ms"],
            "mode": what,
            **({"atomic_adds_per_sample": cell["atomic_adds"]["atomic_adds_per_sample"]}
               if "atomic_adds" in cell else {}),
            **({"pack_ms": cell["pack_ms"]} if "pack_ms" in cell else {}),
            "cell": f"{MAIN['volume']}^3 volume, {MAIN['image']}^2 image",
            "ms_big": cells.get(f"{mode}_{BIG['volume']}_{BIG['image']}", {}).get("ms"),
        })
        if mode == "K2":  # lit K2, on K4's noisy scene; not on the main path's fit
            lit = cells[f"K2_lit_{MAIN['volume']}_{MAIN['image']}"]
            kernels[-1].update({f"lit_{k}": lit[k] for k in ("ms", "bound_ms", "bound_by",
                                                              "plain_ms", "fwd_bwd_ms")})
    for mode, what in (("K6L", "lit voxel-gradient scatter, lookup gradient volumes"),
                       ("K2L", "lit transfer-parameter replay, lookup gradient volumes")):
        cell = cells[f"{mode}_{MAIN['volume']}_{MAIN['image']}"]
        kernels.append({
            "name": f"march_bwd[{mode}]", "route": "cuda",
            "source": "volume_renderer_tpu_torch/csrc/march_bwd.cu",
            "replaces": "volume_renderer_tpu/ops/pallas_march.py:688 (the TPU kernel sends "
                        "lookup gradients to the XLA replay, pallas_march.py:2066-2068)",
            "launches": train_launches[mode], "max_abs_err": grad_abs_err[mode],
            "dp_launches": dp_train_launches.get(mode, 0),
            "max_err_of_scale": grad_err[mode],
            "ms": cell["ms"], "plain_ms": cell["plain_ms"], "plain_rows": cell["plain_rows"],
            "bound_ms": cell["bound_ms"], "bound_by": cell["bound_by"], "library_ms": None,
            "fwd_bwd_ms": cell["fwd_bwd_ms"], "train_step_ms": cell["train_step_ms"],
            "mode": what,
            **({k: cell["atomic_adds"][k] for k in ("atomic_adds_per_sample",
                                                     "reductions_per_sample",
                                                     "sectors_per_sample",
                                                     "sectors_per_sample_scalar")}
               if "atomic_adds" in cell else {}),
            # K2L: the kernel without the packs, each pack, its blocks' tails
            # and its forms in the fit's counted steps
            **({**{k: cell[k] for k in ("kernel_ms", "pack_ms", "pair_pack_ms", "block",
                                        "tail_factor")},
                "launches_by_form": train_forms} if mode == "K2L" else {}),
            "cell": f"{MAIN['volume']}^3 volume, {MAIN['image']}^2 image, K5's noisy scene",
        })
    for form, source, what in (
            ("transmittance", "brick_fwd", "z-brick phase 1: opacity of the brick's own samples"),
            ("segment", "brick_fwd", "z-brick phase 2: shaded segment from the entry opacity"),
            ("scatter", "brick_bwd", "z-brick gradient segment with the scatter")):
        cell = brick_cells[form]
        kernels.append({
            "name": f"{source}[K7 {form}]", "route": "cuda",
            "source": f"volume_renderer_tpu_torch/csrc/{source}.cu",
            "replaces": "volume_renderer_tpu/ops/pallas_march.py:688",
            "launches": brick_launches[form], "max_abs_err": brick_err[form],
            "slab_launches": {path: counts[f"K7_{form}"] for path, counts in slab_launches.items()},
            "rank_launches": rank_launches(f"K7_{form}"),
            "band_check_launches": band_counts[f"K7_{form}"],
            **({"max_err_of_scale": brick_grad_err[0]} if form == "scatter" else {}),
            **({"corner_loads_per_sample": cell["corner_loads"]["loads_per_sample"]}
               if "corner_loads" in cell else {}),
            "ms": cell["ms"], "plain_ms": cell["plain_ms"], "plain_rows": cell["plain_rows"],
            "plain_cell": cell["plain_cell"],
            "bound_ms": cell["bound_ms"], "bound_by": cell["bound_by"], "library_ms": None,
            "mode": what,
            "cell": f"{MAIN['volume']}^3 volume, {MAIN['image']}^2 image, {BRICKS} bricks "
                    f"(ms over all bricks)",
        })
    for form, source, what in (
            ("segment_lit", "brick_fwd", "z-brick lit phase 2: K4's step (and K5's on a packed "
                                         "window) on the brick's windows from the entry opacity"),
            ("scatter_lit", "brick_bwd", "z-brick lit gradient segment: K6's sample replay on "
                                         "the brick's windows"),
            ("scatter_lookup", "brick_bwd", "z-brick lit lookup gradient segment: K6L's sample "
                                            "replay on the brick's windows (the packed window)")):
        cell = lit_cells[form]
        kernels.append({
            "name": f"{source}[K7 {form}]", "route": "cuda",
            "source": f"volume_renderer_tpu_torch/csrc/{source}.cu",
            "replaces": "volume_renderer_tpu/ops/pallas_march.py:688",
            "launches": lit_brick_launches[f"K7_{form}"], "max_abs_err": brick_err[form],
            "slab_launches": {path: counts[f"K7_{form}"] for path, counts in lit_launches.items()},
            "rank_launches": rank_launches(f"K7_{form}"),
            "band_check_launches": band_counts[f"K7_{form}"],
            **({"max_err_of_scale": brick_grad_err[0]} if form != "segment_lit" else {}),
            **({"lookup": {k: lit_cells["segment_lit_lookup"][k]
                           for k in ("ms", "samples", "bound_ms", "bound_by", "pack_ms")},
                "tail_factors_4_bricks": cell["tail_factors"]["bricks"]}
               if form == "segment_lit" else {}),
            **({k: cell["atomic_adds"][k] for k in ("atomic_adds_per_sample",
                                                     "reductions_per_sample",
                                                     "sectors_per_sample",
                                                     "sectors_per_sample_scalar")
                if k in cell["atomic_adds"]} if form != "segment_lit" else {}),
            "ms": cell["ms"], "plain_ms": cell["plain_ms"], "plain_rows": cell["plain_rows"],
            "plain_cell": cell["plain_cell"],
            "bound_ms": cell["bound_ms"], "bound_by": cell["bound_by"], "library_ms": None,
            "mode": what,
            "cell": f"{MAIN['volume']}^3 volume, {MAIN['image']}^2 image, {BRICKS} bricks "
                    f"(ms over all bricks), the noisy lit "
                    f"{'K5' if form == 'scatter_lookup' else 'K4'} scene",
        })
    for name, cell in cells.items():
        if "finite" in cell and not (cell["finite"] and cell["nonzero_frac"] > 0.05):
            raise RuntimeError(f"cell {name} rendered nothing useful: {cell}")
    unlaunched = [k["name"] for k in kernels if not k["launches"]]
    if unlaunched:
        raise RuntimeError(f"the main path's counts show no launch of {unlaunched}")
    record({"kernels": kernels})
    if args.out:
        with open(args.out, "w") as f:
            for obj in lines:
                f.write(json.dumps(obj) + "\n")
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
