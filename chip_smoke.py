"""Smoke test of the PyTorch port (mjrl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card; without one it
exits non-zero and prints no result. Phases, any failure exits non-zero:

1. Build: kernel K1 (mjrl_tpu_torch/csrc/mj_kernel.cu, penalty solver, one
   warp per env) in the first two size classes (physics/pkernel.py
   SIZE_CLASSES: the small models and humanoid), K2
   (csrc/mj_newton_kernel.cu, Newton solver, one warp per env) in the
   first, K3 (csrc/mj_ext_kernel.cu, Adroit's stages, one warp per env)
   and K4 (csrc/mj_ext_newton_kernel.cu, Adroit's stages under the Newton
   solver, one warp per env) and the pose kernel (csrc/mj_poses_kernel.cu,
   the Adroit envs' link poses and sites, one warp per env) in the third,
   with nvcc for sm_90a from the checkout's sources, the six builds side by
   side.
2. K1 against plain: K1 against its plain PyTorch version (physics/soa.py)
   on the card, ant (penalty, 4 substeps per frame) at B=1024 and a ragged
   B=1000, one control step (5 frames x 4 substeps) and 6 chained control
   steps from warmed states, each step held against the plain version from
   the same state; prints max |err| of q and qd against the tolerances
   below and both times (CUDA events). Every K1 and K2 phase (2-5, 8-10)
   also launches the kernel at its full batch twice with the default warps
   per block and once each with 1 and with the most, and fails unless q,
   qd (and K2's picks) are bit for bit the same (the check for a missing
   __syncwarp(), which no sanitizer reads on that machine).
3. K2 against plain: the same for K2 and the plain Newton version
   (physics/soa.py + physics/soa_newton.py) on ant with the Newton solver,
   n_substeps=1, 10 iterations (5 substeps per control step), from states
   settled on the floor, one control step and 3 chained ones at B=1024 and
   B=1000; also counts the envs whose line search picked another fraction
   than the plain version's in any iteration, and in the first (full-size)
   iteration of a substep; K2's held-row overflow counter must stay 0.
4. K1 on hopper against plain (slide joints, capsule-capsule contacts
   between links): B=256 and a ragged B=250, one control step (4 frames x
   1 substep) and 6 chained ones, from states warmed by random actions and,
   in half the batch, folded so a capsule-capsule pair overlaps
   (physics/probe.py); counts the env-steps with a capsule-capsule
   candidate at depth > 0 and fails if there is none; both times at B=256.
5. K1 on walker2d and half_cheetah against plain: one control step each at
   B=1024 from states warmed by random actions; and K1 on walker2d at the
   walker2d TRPO path's B=4096 and a ragged B=4090, one control step and 6
   chained ones, both times at B=4096.
6. The penalty slice: 3 full Ant NPG iterations at the bench's width (1024
   envs x 100 steps, episodes mode, policy (64, 64),
   MLPBaseline(epochs=2, batch_size=1024), normalized_step_size=0.05);
   every metric finite, all state on the card, exactly 100 K1 launches per
   iteration.
7. The Newton slice: 3 iterations of the bench's Newton row (newton,
   n_substeps=1, samples mode with the persistent sampler carry, 1024 envs
   x 100-step windows, the same policy, baseline and step size); every
   metric finite, all state and the carry on the card, exactly 100 K2 and
   0 K1 launches per iteration, and rows mid-episode carried into the next
   window.
8. K2 on hopper against plain (contacts between two moving links): hopper
   with the Newton solver, 1 substep per frame, 10 iterations (4 substeps
   per control step), B=256 and a ragged B=250, one control step and 3
   chained ones, from states warmed by random actions and, in half the
   batch, folded so a capsule-capsule pair lies inside its margin; counts
   the env-steps that hold a row between two moving links and fails if
   there is none; line-search flips as in phase 3; both times at B=256.
   Then K2 on hopper with every geom forced to condim 1 (one row per
   contact) and to condim 4 (six facets, torsional friction): one control
   step at B=250, half folded, half warmed, to K2's tolerance.
9. K1 on swimmer against plain (the fluid stage), to swimmer's own
   tolerance: B=256 and a ragged B=250, one control step (4 frames x 1
   substep) and 6 chained ones from states warmed by random actions; both
   times at B=256.
10. K1 on humanoid against plain (sphere-sphere and sphere-capsule
   contacts, the large size class), to humanoid's own tolerance: B=1024
   and a ragged B=1018, one control step (5 frames x 2 substeps) and 3
   chained ones, and B=4096, one control step, from states warmed by
   random actions with half the batch folded so a pair of links overlaps;
   counts the env-steps with a sphere-sphere and with a sphere-capsule
   point at depth > 0 and fails if either is 0; both times at B=1024 and
   at B=4096.
11. K3 on Adroit pen against plain (link offsets, box kinds, servos,
   tendons, frictionloss), to its own tolerance: B=512 and a ragged B=506,
   one control step and 3 chained ones from ``adroit_states``; every one
   of pen's five contact kinds must touch; K3's q and qd bit for bit the
   same over two launches and with 1 and with the most warps per block (the
   check for a missing __syncwarp()); both times at B=512. Then K3 on
   Adroit hammer (671 contact points in 229 pairs, 8 rounds of 32; more
   than K1's 512 slots), door (760 points in 278 pairs, 9 rounds) and
   relocate (the sphere kinds, the fullest size class) against plain, each
   to its own tolerance: one control step at B=512 from ``adroit_states``
   of the ported env (half from its reset, the board, the door's frame or
   the ball moved, warmed by random actions through K3), every one of the
   model's contact kinds touching, the launches bit for bit as on pen;
   both times at B=512, and K3's on hammer and relocate at their paths'
   B=2048 (B=512's states four times over).
12. K4 on Adroit pen with the Newton solver against plain, to its own
   tolerance: the same at B=512 (4 envs a block by default, two blocks an
   SM), from ``adroit_states`` warmed by K4; counts the
   env-steps that hold a row of each contact kind, of each facet count (1,
   4, 6) and of a joint limit, and fails if any is 0; the rows held per
   env-step (mean, max), the line-search flips, and K4's overflow counter,
   which must stay 0 (its check raises otherwise). Then one control step
   at B=512 from ``pen_train_states`` (50 steps of the training path's
   policy at init) to the same tolerance. On both state sets, K4's q, qd
   and picks bit for bit the same over two launches and with 1, with 3 (a
   ragged last block) and with the most warps per block (8: the Adroit
   class keeps 14 of its 96 held rows in shared memory and the rest in
   each env's slab in device memory; the check for a missing __syncwarp(),
   which no sanitizer reads on that machine);
   both times at B=512 on both. Then K4 on door (760 contact points),
   hammer and relocate (the sphere kinds, 19-dof chains) with the Newton
   solver, to pen's tolerances, against the plain version on the CPU
   stepping by K4's line-search fractions: one control step at B=256 from
   ``adroit_states`` of the env (half from its reset warmed by K4, half
   where each of the model's contact kinds touches), every one of the
   model's kinds holding a row (the facet counts and limits printed), the
   held rows per env, the line-search flips and the overflow counter,
   which must stay 0; the launches bit for bit as on pen; both times at
   B=256, and K4's at B=512 on B=256's states twice over, its results bit
   for bit B=256's repeated (their bounds: tools/torch_k4_tasks.py, which
   also reads the spreads and the planted faults behind the tolerances).
   Then the pose kernel (physics/pkernel.py ``POSES``) on pen, relocate and
   door with the Newton solver at B=512 and a ragged B=510, from states
   stepped by K4 (the env's ``q`` the transposed view of K4's output, the
   link offsets a transposed view too): every link's position and
   orientation and every site's position against the plain version
   (physics/engine.py ``forward_kinematics`` + ``site_positions``) on the
   card to ``POSE_TOL``, the world sites equal, two launches bit for bit;
   its device time per launch (torch.profiler), the stream's time per call
   and the plain version's, and its bound, at B=512 (``phase_poses``).
13. Twenty-two paths through the entry point at full width, ``run_job`` of
   mjrl_tpu_torch.train with save_freq=1 into a temporary directory each:
   examples/hopper_npg.json (256 envs x 1000 steps, K1) with niter=1 and
   then niter=2, the second call resuming from the first one's checkpoint;
   examples/hopper_npg_newton.json (256 x 1000, K2),
   examples/swimmer_npg.json (256 x 1000, K1) and
   examples/walker2d_trpo.json (4096 x 1000, K1, TRPO) with niter=1;
   examples/humanoid_ppo_v4.json (PPO, obs_norm, 4096 envs x 64-step
   windows in samples mode, K1) with niter=1 and then niter=2, resumed, so
   the second iteration runs with the annealed learning rate and the
   sampler carry from the checkpoint; examples/humanoid_trpo.json (TRPO,
   obs_norm, 1024 x 1000, K1) with niter=1; examples/adroit_pen_npg.json
   (512 x 100, K3) and examples/adroit_pen_npg_newton.json (512 x 100, K4)
   with niter=1 and then niter=2, resumed; examples/adroit_door_npg.json
   (512 x 200, K3), examples/adroit_hammer_npg.json at hammer's
   fixed-physics width (num_traj=2048: 2048 x 200, K3, the nail's sensor
   in every observation) and examples/adroit_relocate_scratch.json (2048 x
   200, K3) with niter=1; the same door, hammer (at its config's 512 x 200)
   and relocate configs with ``env_kwargs.constraint_solver="newton"`` (K4)
   with niter=1. Exactly the path's launches of its kernel per
   iteration (1000, 200, 100, or humanoid PPO's 64) and 0 of
   the others, the obs_norm rollout's counted apart (one more window or
   episode); on the pen, door and relocate paths (the DAPG ones too) also
   exactly 101 or 201 launches of the pose kernel per iteration (each
   control step and the reset), and none on the others; every logged
   value finite, the agent's state on the card, log.csv and the
   checkpoints written; prints each iteration's ms, valid
   and computed env-steps/s, score and, for TRPO, backtrack_iters and
   step_accepted, for PPO alpha, kl_dist and log_std_mean.
   Then the five DAPG configs (BC warm start, then DAPG):
   examples/adroit_pen_dapg.json (64 x 100, K3) with niter=1 and then
   niter=2, resumed; examples/adroit_door_dapg.json and
   adroit_hammer_dapg.json (64 x 200, K3), adroit_relocate_dapg.json
   (2048 x 200, K3) and hopper_dapg.json (64 x 1000, K1) with niter=1.
   The card's copy has no ``demos/``, so each first makes its demos there:
   25 eval-mode episodes (the policy mean) of the config's initial policy
   at its horizon, through ``batch_to_paths`` into a pickle that
   ``demo_file`` names, their launches counted apart. BC runs once, in
   the first call, and its loss must fall (both printed); the logged
   ``demo_coef`` of each iteration must be ``lam_0 * lam_1**i``. Then one
   more pen DAPG call starts a run with ``init_policy_from`` the first
   run's directory and ``bc_init=false``: its first policy must equal that
   checkpoint's, on the card. Then examples/point_mass_npg.json (64 x 25,
   the quadratic baseline, 16 evaluation episodes after the step): no
   kernel launch at all, ``eval_score`` logged and finite. Last the two
   model-based NPG configs: examples/hopper_model_npg.json at full width
   (64 real episodes x 500 steps on K1, a 4-member (256, 256) ensemble fit
   for 20 epochs, 1024 imagined episodes x 500 steps, NPG and the MLP
   baseline on the imagined batch) with niter=1 and then niter=2, resumed,
   and examples/point_mass_model_npg.json (16 x 25 real, 256 x 25
   imagined, no kernel) with niter=1: exactly 500 K1 launches per hopper
   iteration and none during the imagined rollout (counted around it);
   the imagined batch is img_traj x img_horizon and each imagined episode
   starts from a valid observation of that iteration's real batch;
   ``dyn_error`` finite and under 0.5 at hopper's first iteration (targets
   of unit variance: an unfitted ensemble reads ~1; point_mass's 10 Adam
   steps: under 0.7, where the JAX package reads 0.58-0.60); ``running_score`` after
   the first iteration equals its ``stoc_pol_mean``; the ensemble's
   parameters, normalizers and Adam moments on the card, and the resumed
   call's equal to the checkpoint's.
14. The breadth items, one iteration each on the card through ``run_job``
   (examples/point_mass_npg.json's settings): point_mass with
   ``policy="linear"`` and ``algorithm="reinforce"``, cartpole NPG with
   ``agent_kwargs.hvp_sample_frac=0.5`` (its FVP mask drawn once) and
   pendulum NPG; every logged value finite, the state on the card, no
   kernel launched (the pose kernel's included).
15. Data parallelism (mjrl_tpu_torch/parallel/dist.py): two ranks, spawned
   processes sharing cuda:0 over gloo. Ant NPG at the bench's width (1024
   envs x 100 steps, phase 6's agent), two iterations, on one rank in this
   process and on the two ranks: each rank launches K1 exactly 100 times
   per iteration on its 512 envs; in the first iteration each rank's rows
   of the sampled batch against the matching rows of the single-rank batch
   (bit for bit, or else the step and field where they first part and
   their difference there, which must be round-off: under ``DP_ROW_TOL``),
   ``num_samples`` equal, the ranks' parameters the same bits (an
   all-reduce MAX and MIN of a checksum) and within ``DP_PARAM_TOL`` of the
   single-rank step; the second iteration's ms on one rank and on two.
   Then examples/humanoid_ppo_v4.json with ``mesh_devices=2`` through
   ``run_job`` on each rank (niter=2: obs_norm, PPO's sharded path with its
   32 Adam steps, the MLP baseline's fit), exactly 64 K1 launches per rank
   per iteration and 64 for the obs_norm rollout, the ranks' replicated
   state held at each checkpoint (``train_agent``), the log written by rank
   0 alone; then ``run_job`` in this process spawning the two ranks itself
   resumes the run to iteration 3. Prints the second iteration's ms on two
   ranks beside phase 13's single-rank one. Where ``torch.cuda.device_count()
   >= 2`` the ant run is repeated over NCCL, a card per rank; otherwise a line
   says NCCL did not run. A rank that fails fails the script.
16. The per-env engine (physics/engine.py, csolve.py: the frame stepper's
   path with ``use_soa=False``, for ball joints and planes on a moving
   link): (i) one control step of the engine against K1 (ant penalty, phase
   2's states), K2 (hopper Newton, phase 8's folded states), K3 (pen, phase
   11's ``adroit_states``) and K4 (pen Newton, phase 12's) at B=256 from
   the same states, each to its kernel's tolerance plus the engine's own
   spread (``ENGINE_SPREAD_TOL``; K4 also on the 99% quantile), no kernel
   launched by the engine, both times; (ii) the ball-joint chain and the
   link-mounted planes of physics/probe.py, 3 chained control steps of 5
   frames at B=256 on the card, each held against the engine on the CPU
   from the same inputs (``ENGINE_SMALL_TOL``), their ball and free joints'
   quaternion norms within 1e-5 of 1; (iii) path (a): two DAPG iterations
   of runs/adroit_pen_dapg_newton_s1's settings (examples/
   adroit_pen_dapg.json with ``env_kwargs.use_soa=false`` and Newton
   contacts, seed 211; 64 envs x 100 steps, BC on the card's own demos)
   through ``run_job`` as phase 13 runs its paths, with 0 launches of K1-K4
   and of the pose kernel (the engine path's observation is plain) and every
   control step through ``engine.step``, and the same config with
   ``use_soa`` unset launching K4 100 times and the pose kernel 101 times per
   iteration; (iv) ``evaluate_policy`` (8 eval-mode episodes) and
   ``export_rollout`` (one episode), 20 steps each, on that engine path,
   finite, with the reference's keys, no kernel launched. Prints
   the results on a line of their own, ``{"engine": ...}``.
17. The card's name and power limit from nvidia-smi.

Each kernel's launch count in the JSON line is its count over the slice
that runs it (phase 6 for K1, phase 7 for K2; K1's ``hopper_model_npg``,
``hopper``,
``swimmer``, ``walker2d_trpo``, ``humanoid_trpo`` and ``humanoid_ppo``
entries, K2's ``hopper`` entry, K3 and K4: their path in phase 13, the
obs_norm rollout included), reset to 0 just before. Each K1, K2 and K3
entry holds the warps per block its default launch took; K3's ``hammer``,
``door`` and ``relocate`` entries their check and their path's launches,
and K4's the same for its Newton paths;
K1's ``hopper_dapg`` and K3's ``pen_dapg``, ``door_dapg``, ``hammer_dapg``
and ``relocate_dapg`` entries their DAPG path's launches (the warm-started
call's included, the demos' not); K1's ``ant_dp`` and ``humanoid_ppo_dp``
entries each rank's launches in phase 15 (per iteration for ant; for
humanoid over the first call, obs_norm included); the pose kernel's
``launches_per_iteration`` what phase 13 held each of its paths to.
``bound_ms`` is the least
time the card could take for one control step (the pose kernel: one
launch, whose ``ms`` is its device time) at the check's batch: the
larger of the bytes the kernel must move (state in and out, its tables)
over 3.35 TB/s and its f32 operations over 67 TFLOP/s, with the
operations counted per env-substep on the plain version (which does the
kernel's arithmetic) and, for K2 and K4, for the rows this run's states
hold (the count with no row held, plus each held row's). No single PyTorch call
computes either function, so ``library_ms`` is null. The line before the
last two holds one JSON object describing each kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import csv
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# Kernel vs plain on the card, max |err| of one control step from the same
# state. Both are f32 with the same formulas in another order (nvcc
# contracts to FMA). K1: the stiff penalty contacts grow that round-off
# within a control step (the plain version on the card and on the CPU
# already differ by up to 6.4e-3 in qd on warmed ants; PERF.md); the same
# tolerances hold for every model K1 runs, hopper's stiffer contacts
# between links included. K2: the soft constraints are implicit and do not
# grow it, but a converged Newton iteration's five line-search costs can
# tie to round-off, and the two then pick other fractions of a step of
# round-off size; the tolerances are those of
# tests/test_torch_newton_kernel.py's card test. The chained checks step
# the kernel and hold every step against the plain version started from
# the kernel's own state; free-running trajectories diverge from round-off
# alone, so they are not compared. K1 on swimmer (no contacts, the fluid
# stage) has its own: ten times the largest spread between the plain
# version on the card and on the CPU (5.4e-7 in q, 1.3e-5 in qd),
# rounded up to a power of ten (tools/torch_fluid_check.py, PERF.md), so
# that drag constants 1% off (1.1e-2 in qd) fail. K1 on humanoid has its
# own by the same rule, on a quantile: its penalty forces jump where a
# closing contact's depth crosses 0 and where a joint crosses its limit,
# and the rare env-steps near such an event take either side of it from
# round-off, where even the plain version on the card and on the CPU
# disagree by up to 1e-1 in qd. So humanoid's tolerance is ten times the
# 99% quantile of that spread's per env-step max |err|, rounded up to a
# power of ten and no looser than K1's, and it bounds the same quantile of
# K1's per env-step error (tools/torch_humanoid_check.py, PERF.md: the
# spread's quantile is 3.6e-6 in q, 1.2e-3 in qd); a sphere-capsule radius
# 2% off reads 2e-2 / 2.7 there and fails it.
# K3 on pen has its own by swimmer's rule: ten times the largest spread
# between the plain version on the card and on the CPU (1.0e-6 in q, 1.9e-4
# in qd over adroit_states' 512 and 506 pen envs x 3 chained steps), rounded up
# to a power of ten; every box's half-sizes 2% too large read 3.2e-3 / 0.34
# there and every tendon's limit stiffness 2% too large 1.9e-3 / 0.28, and
# both fail it (tools/torch_adroit_check.py, PERF.md). K3 on hammer by the
# same rule: the plain version on the card and on the CPU differ by up to
# 1.3e-6 in q and 8.4e-4 in qd over hammer_states' 512 and 506 envs x 3
# chained steps, so 1e-4 / 1e-2; every box's half-sizes 2% too large read
# 1.3e-2 / 2.3 there and every tendon's limit stiffness 2% too large
# 3.6e-3 / 0.54, and both fail it. K3 on door and on relocate by the same
# rule, each from its own spread over adroit_states' 512 and 506 envs x 3
# chained steps (tools/torch_adroit_check.py door relocate, PERF.md).
# K4 on pen by the same rule: the plain version on the card and on the CPU
# differ by up to 2.0e-5 in q and 4.7e-3 in qd (over adroit_states' 512 and
# 506 envs x 3 chained steps: a converged Newton iteration's line-search
# ties flip on round-off at a few env-steps), so 1e-3 / 1e-1; K4 reads
# 4.8e-5 / 1.15e-2. Frictionloss's diagonal left out of the Newton metric
# fails that max by only 8-13%, so K4 is also held to the 99% quantile of
# its per env-step error, by humanoid's rule (ten times the spread's
# quantile, 2.7e-7 / 3.8e-5, up to a power of ten): 1e-5 / 1e-3, where K4
# reads 1.3e-6 / 1.9e-4 and the missing diagonal 4.9e-4 / 5.7e-2, every box
# geom's solref 2% off 2.2e-3 / 0.32 and the condim-4 torsional friction 2%
# off 4.7e-4 / 6.7e-2 (tools/torch_adroit_newton_check.py, PERF.md).
# K4 on door, hammer and relocate is held to pen's tolerances with the
# plain version stepping by K4's line-search fractions (phase_k4's
# ``replay``). Free-running, the plain version on the card and on the CPU
# differ there by up to 2.1e-5 / 2.6e-3 (door), 3.9e-5 / 7.9e-3 (hammer)
# and 2.4e-5 / 5.1e-3 (relocate), with 99% quantiles of 9.7e-6 / 1.7e-3,
# 4.6e-6 / 1.0e-3 and 1.2e-5 / 1.3e-3, over pen's quantile tolerance:
# their kind states (a box or capsule up to 1 cm in the table, 57-71 rows
# held) tie the line search's costs in many more envs than pen's, and a
# tie that flips on round-off moves the step by a whole fraction. The
# replay takes those flips out and leaves the rows, the metric and the
# Newton direction to the comparison; the line search, whose code all four
# tasks share, is held free-running on pen. With the fractions replayed the
# plain version on the card and on the CPU differ by 99% quantiles of at
# most 1.0e-6 / 1.8e-4 and K4 reads at most 2.0e-6 / 5.2e-4 (door), while
# each of pen's three planted faults fails pen's tolerances on each task,
# the mildest (every geom's torsional friction 2% too large) at 5.1e-2 to
# 1.1e-1 in qd's quantile (tools/torch_k4_tasks.py --faults, PERF.md).
TOL = {"K1": {"q": 1e-3, "qd": 5e-2}, "K2": {"q": 1e-4, "qd": 1e-2},
       "K1 swimmer": {"q": 1e-5, "qd": 1e-3}, "K1 humanoid": {"q": 1e-4, "qd": 5e-2},
       "K3 pen": {"q": 1e-4, "qd": 1e-2}, "K3 hammer": {"q": 1e-4, "qd": 1e-2},
       "K3 door": {"q": 1e-4, "qd": 1e-2}, "K3 relocate": {"q": 1e-4, "qd": 1e-2},
       "K4 pen": {"q": 1e-3, "qd": 1e-1},
       "K4 pen quantile": {"q": 1e-5, "qd": 1e-3}}
HUMANOID_QUANTILE = 0.99
NUM_ENVS, HORIZON, ITERS = 1024, 100, 3
HOPPER_ENVS, HOPPER_HORIZON = 256, 1000  # examples/hopper_npg.json
TRPO_ENVS = 4096  # examples/walker2d_trpo.json
HUMANOID_TRPO_ENVS, HUMANOID_PPO_ENVS, PPO_WINDOW = 1024, 4096, 64  # examples/humanoid_*.json
PEN_ENVS, PEN_HORIZON = 512, 100  # examples/adroit_pen_npg.json
ADROIT_HORIZON, ADROIT_WIDE = 200, 2048  # door, hammer and relocate; hammer's fixed width
DAPG_ENVS, POINT_MASS_HORIZON = 64, 25  # examples/*_dapg.json but relocate; point_mass_npg.json
MODEL_ENVS, MODEL_HORIZON = 64, 500  # examples/hopper_model_npg.json's real rollout
NEWTON = 'env_kwargs.constraint_solver="newton"'  # door, hammer and relocate on K4
K4_TASK_ENVS = 256  # phase 12's check of K4 on door, hammer and relocate (and twice that, timed)
# phase 12's pose kernel: the Adroit tasks whose observation runs it (on K3
# and K4) and the control steps that warm its states. The kernel computes
# the plain version's f32 formulas link by link; on the card they part by
# at most 3.7e-7 (PERF.md), so 1e-5, where a site's offset 2% too long
# moves it by 3e-4 or more (the shortest offset on a link is 14.8 mm).
POSE_TASKS, POSE_WARM_STEPS, POSE_TOL = ("pen", "relocate", "door"), 5, 1e-5
# the paths through the entry point (phase 13): config, kernel, envs, steps
# per iteration (the episode or the samples-mode window), run_job's niter
# per call, and overrides of the config
ENTRY_PATHS = (("hopper", "hopper_npg.json", "K1", 256, HOPPER_HORIZON, (1, 2), ()),
               ("hopper_newton", "hopper_npg_newton.json", "K2", 256, HOPPER_HORIZON, (1,), ()),
               ("swimmer", "swimmer_npg.json", "K1", 256, HOPPER_HORIZON, (1,), ()),
               ("walker2d_trpo", "walker2d_trpo.json", "K1", TRPO_ENVS, HOPPER_HORIZON, (1,), ()),
               ("humanoid_ppo", "humanoid_ppo_v4.json", "K1", HUMANOID_PPO_ENVS, PPO_WINDOW,
                (1, 2), ()),
               ("humanoid_trpo", "humanoid_trpo.json", "K1", HUMANOID_TRPO_ENVS, HOPPER_HORIZON,
                (1,), ()),
               ("adroit_pen", "adroit_pen_npg.json", "K3", PEN_ENVS, PEN_HORIZON, (1, 2), ()),
               ("adroit_pen_newton", "adroit_pen_npg_newton.json", "K4", PEN_ENVS, PEN_HORIZON,
                (1, 2), ()),
               ("adroit_door", "adroit_door_npg.json", "K3", PEN_ENVS, ADROIT_HORIZON, (1,), ()),
               ("adroit_hammer", "adroit_hammer_npg.json", "K3", ADROIT_WIDE, ADROIT_HORIZON, (1,),
                (f"num_traj={ADROIT_WIDE}",)),
               ("adroit_relocate", "adroit_relocate_scratch.json", "K3", ADROIT_WIDE,
                ADROIT_HORIZON, (1,), ()),
               ("adroit_door_newton", "adroit_door_npg.json", "K4", PEN_ENVS, ADROIT_HORIZON, (1,),
                (NEWTON,)),
               ("adroit_hammer_newton", "adroit_hammer_npg.json", "K4", PEN_ENVS, ADROIT_HORIZON,
                (1,), (NEWTON,)),
               ("adroit_relocate_newton", "adroit_relocate_scratch.json", "K4", ADROIT_WIDE,
                ADROIT_HORIZON, (1,), (NEWTON,)),
               ("adroit_pen_dapg", "adroit_pen_dapg.json", "K3", DAPG_ENVS, PEN_HORIZON, (1, 2),
                ()),
               ("adroit_door_dapg", "adroit_door_dapg.json", "K3", DAPG_ENVS, ADROIT_HORIZON, (1,),
                ()),
               ("adroit_hammer_dapg", "adroit_hammer_dapg.json", "K3", DAPG_ENVS, ADROIT_HORIZON,
                (1,), ()),
               ("adroit_relocate_dapg", "adroit_relocate_dapg.json", "K3", ADROIT_WIDE,
                ADROIT_HORIZON, (1,), ()),
               ("hopper_dapg", "hopper_dapg.json", "K1", DAPG_ENVS, HOPPER_HORIZON, (1,), ()),
               ("point_mass", "point_mass_npg.json", None, DAPG_ENVS, POINT_MASS_HORIZON, (1,), ()),
               ("hopper_model_npg", "hopper_model_npg.json", "K1", MODEL_ENVS, MODEL_HORIZON,
                (1, 2), ()),
               ("point_mass_model", "point_mass_model_npg.json", None, 16, POINT_MASS_HORIZON, (1,),
                ()))
# phase 14: the breadth items on examples/point_mass_npg.json's settings
BREADTH_ROWS = (("point_mass_linear_reinforce", ("policy=\"linear\"", "algorithm=\"reinforce\"",
                                                 "agent_kwargs={}")),
                ("cartpole_hvp", ("env_name=\"cartpole\"", "agent_kwargs.hvp_sample_frac=0.5")),
                ("pendulum", ("env_name=\"pendulum\"",)))
# the first iteration's dyn_error bound (normalized targets: an unfitted
# ensemble reads ~1): hopper's 2480 Adam steps bring it to JAX's 0.048-0.060
# (runs/hopper_model_npg*); point_mass fits 10 steps, where the JAX package
# on the CPU reads 0.58-0.60 with seeds 0-2
DYN_ERROR_MAX = {"hopper_model_npg": 0.5, "point_mass_model": 0.7}
# the DAPG paths: the demos each makes on the card, and the path that also
# warm starts a run from its checkpoint (init_policy_from)
DEMO_PATHS, WARM_START_PATH = 25, "adroit_pen_dapg"
# phase 15: ranks, the two iterations' seeds, the sampled rows held, the
# parameters' tolerance against one rank (an MLP policy's NPG step: CG grows
# the sums' reordering by the ranks; on the CPU the same step moves by up to
# 4.3e-5 on point_mass, tests/test_torch_parallel.py) and the largest
# difference allowed where a row first parts from one rank's (round-off of
# one step: nothing else may differ)
DP_RANKS, DP_SEEDS = 2, (11, 12)
DP_FIELDS = ("observations", "actions", "rewards", "valid", "done", "mean", "log_std")
DP_PARAM_TOL, DP_ROW_TOL = 1e-3, 1e-4
# phase 16: the per-env engine (physics/engine.py) against each kernel on
# that kernel's earlier phase's states, one control step at ENGINE_ENVS:
# (row, env, its make() keywords, kernel). The engine and the plain version
# compute the same physics in another order (a dense Cholesky where the
# plain one walks the dof chains; rows built apart), and the kernel is held
# to the plain version within TOL; so the kernel against the engine is held
# to TOL plus ten times the engine-vs-plain spread on the CPU over the same
# states, rounded up to a power of ten (tools/torch_engine_check.py, PERF.md;
# K4 on its 99% quantile, as its own check). The models outside the
# kernels' set: the card against the CPU from the same inputs, per control
# step of 5 frames, to the JAX package's bounds for its engine against its
# fast path over one frame (tests/test_soa.py: q rtol 1e-3 / atol 1e-4, qd
# 5e-3 / 5e-3); a one-ulp perturbation of the inputs moves these models by
# under a tenth of those bounds over a control step on the CPU.
ENGINE_ENVS = 256
ENGINE_ROWS = (("ant", "ant", {}, "K1"),
               ("hopper_newton", "hopper", {"constraint_solver": "newton"}, "K2"),
               ("pen", "adroit_pen", {}, "K3"),
               ("pen_newton", "adroit_pen", {"constraint_solver": "newton"}, "K4"))
# (on the CPU at B=256 the engine parts from the plain version by up to
# ant 3.6e-7 / 4.5e-5, hopper Newton 3.0e-8 / 1.3e-6, pen 9.5e-7 / 1.1e-4,
# pen Newton 5.7e-5 / 8.7e-3 with a 99% quantile of 1.9e-5 / 2.2e-3: the
# Newton iterations' line search picks other fractions where round-off
# ties its costs)
ENGINE_SPREAD_TOL = {"ant": {"q": 1e-5, "qd": 1e-3}, "hopper_newton": {"q": 1e-6, "qd": 1e-4},
                     "pen": {"q": 1e-5, "qd": 1e-2},
                     "pen_newton": {"q": 1e-3, "qd": 1e-1, "q_quantile": 1e-3,
                                    "qd_quantile": 1e-1}}
ENGINE_SMALL_TOL = {"q": (1e-3, 1e-4), "qd": (5e-3, 5e-3)}  # (rtol, atol)
ENGINE_SMALL_STEPS, ENGINE_FRAMES, QUAT_NORM_TOL = 3, 5, 1e-5
ENGINE_EVAL_HORIZON = 20  # (iv)'s episodes, cut from pen's 100 for the phase's time
# path (a): examples/adroit_pen_dapg.json with runs/adroit_pen_dapg_newton_s1's
# settings (the runs/ folder is not copied to the card)
ENGINE_PATH = ("adroit_pen_dapg_engine", "adroit_pen_dapg.json",
               ('env_kwargs={"constraint_solver": "newton", "use_soa": false}', "seed=211"))
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12  # H100 SXM data sheet
ROOT = Path(__file__).resolve().parent

_ARITH = {"add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt", "rsqrt", "sin", "cos",
          "pow", "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "reciprocal", "tanh"}


def _cuda_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _f32_ops(fn) -> int:
    """f32 arithmetic operations of ``fn()`` (elements produced by
    add/mul/div/sqrt/sin/... and reduced by sum), counted under a dispatch
    counter."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in _ARITH and isinstance(out, torch.Tensor) and out.is_floating_point():
                Count.n += out.numel()
            elif name == "sum":
                Count.n += args[0].numel() - out.numel()
            elif name == "mm":  # the tendons' Jq q, Jv qd, Jv^T f: their nonzeros
                Count.n += 2 * int((args[0] != 0).sum()) * out.shape[1]
            return out

    with Count():
        fn()
    return Count.n


def _f32_ops_per_env_substep(model, q, qd, ctrl, link_delta=None) -> float:
    """f32 arithmetic operations of one plain substep per env, counted by
    running the plain version on the CPU (:func:`_f32_ops`)."""
    from mjrl_tpu_torch.physics import soa

    q, qd, ctrl = (x.cpu() for x in (q, qd, ctrl))
    if link_delta is not None:
        link_delta = link_delta.cpu()
    n = _f32_ops(lambda: soa.substep(model, q, qd, ctrl, model.dt / model.n_substeps,
                                     link_delta=link_delta))
    return n / q.shape[1]


def _bound_ms(model, n_sub: int, ops_per_env_substep: float, tables, batch: int,
              extra_rows: int = 0) -> tuple:
    io = (2 * model.nq + 2 * model.nv + model.nu + extra_rows) * 4 * batch
    t_bytes = (io + sum(t.numel() * 4 for t in tables)) / HBM_BYTES_PER_S
    t_ops = ops_per_env_substep * n_sub * batch / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def _newton_op_count(model, q, qd, ctrl, held_cand: float, held_lim: float,
                     link_delta=None, max_pairs: int = 16) -> float:
    """K2's and K4's operations per env-substep for the rows this run
    holds: the plain version's count with no row held (the pipeline, the
    narrow phase of every contact point and the iterations' dense algebra),
    plus the count of one held contact row, from the plain version with a
    row for every point of the model cut to at most ``max_pairs`` of the
    pairs that hold a row in some env at the states ``q`` (evenly spaced
    in the model's order), and of one held limit row, from a model with one
    contact pair with and without its limits (the kernels hold only the
    rows inside their margin)."""
    from mjrl_tpu_torch.physics import soa, soa_newton
    from mjrl_tpu_torch.physics.tables import num_contact_candidates

    cands = soa._contact_candidates(model, *soa._fk(model, q, link_delta))
    kept = {frozenset((c.gi, c.gj)) for c in soa_newton._in_margin_somewhere(model, cands)}
    held_pairs = tuple(p for p in model.contact_pairs if frozenset(p) in kept)
    step = max(1, -(-len(held_pairs) // max_pairs))  # 1 where no pair holds a row
    held_pairs = held_pairs[::step] or model.contact_pairs[:1]
    q, qd, ctrl = q[:, :1], qd[:, :1], ctrl[:, :1]
    if link_delta is not None:
        link_delta = link_delta[:, :1]

    def ops(m, rows):
        held = soa_newton._in_margin_somewhere
        soa_newton._in_margin_somewhere = lambda _, cands: cands if rows else []
        try:
            return _f32_ops_per_env_substep(m, q, qd, ctrl, link_delta)
        finally:
            soa_newton._in_margin_somewhere = held

    def variant(pairs, limited):
        m = copy.copy(model)
        m.contact_pairs, m._pair_groups = pairs, None
        m.jnt_limited = limited
        return m

    n_lim = sum(1 for v in model.jnt_limited if v > 0)
    one_pair = model.contact_pairs[:1]
    per_lim = (ops(variant(one_pair, model.jnt_limited), True) - ops(variant(
        one_pair, tuple(0 for _ in model.jnt_limited)), True)) / n_lim
    no_row = ops(model, False) - n_lim * per_lim
    cut = variant(held_pairs, model.jnt_limited)
    per_row = (ops(cut, True) - ops(cut, False)) / num_contact_candidates(cut)
    return no_row + held_cand * per_row + held_lim * per_lim


def _held_rows(model, q):
    """Mean rows inside their margin per env at the states ``q`` (nq, B):
    contact candidates with depth > -margin, limit rows out of range."""
    from mjrl_tpu_torch.physics import probe

    rows = probe.held_rows(model, q)
    return float(rows["contacts"].float().mean()), float(rows["limits"].float().mean())


SPHERE_KINDS = ("sphere_sphere", "sphere_capsule")


def kind_contacts(model, q, kinds=SPHERE_KINDS):
    """Per contact kind of ``kinds``, the envs with a point of that kind at
    depth > 0 at the states ``q`` (nq, B)."""
    from mjrl_tpu_torch.physics import probe

    depth = probe.kind_depth(model, q)
    return {k: int((depth[k] > 0).sum()) for k in kinds}


def start_states(env, full, n_chain, warm_steps=10, warm_scale=1.0, fold=False):
    """``(q (nq, full), qd (nv, full), [ctrl (nu, full)] * n_chain)`` on the
    env's device: states after ``warm_steps`` control steps of random
    actions times ``warm_scale`` from reset, with half the batch replaced by
    states where a pair of links overlaps if ``fold``, and the controls of
    ``n_chain`` chained steps (numpy seed 0, torch seed 0)."""
    import numpy as np
    import torch

    from mjrl_tpu_torch.physics import probe

    model, dev = env.model, env.device
    rng = np.random.default_rng(0)

    def rand_ctrl():
        return torch.as_tensor(rng.uniform(-1, 1, (model.nu, full)), dtype=torch.float32, device=dev)

    state, _ = env.reset(full, torch.Generator(device=dev).manual_seed(0))
    for _ in range(warm_steps):
        state, *_ = env.step(state, rand_ctrl().T * warm_scale)
    q0, qd0 = state.q.T.contiguous(), state.qd.T.contiguous()
    if fold:
        half = full // 2
        fq, fqd = probe.overlapping_states(model, full - half, rng)
        q0[:, half:], qd0[:, half:] = torch.as_tensor(fq, device=dev), torch.as_tensor(fqd, device=dev)
    return q0, qd0, [rand_ctrl() for _ in range(n_chain)]


PEN_KINDS = ("box_plane", "capsule_plane", "capsule_box", "box_box", "capsule_capsule")


def adroit_states(env, full, n_chain, warm_steps=10):
    """``(q (nq, full), qd (nv, full), link_delta (3 nlink, full), [ctrl (nu,
    full)] * n_chain)`` on the env's device for an Adroit env: the first
    half after ``warm_steps`` control steps of random actions from reset
    (K3 on the card), their links offset by the env's own scene offsets
    (hammer's board, door's frame, relocate's ball; none for pen) plus a
    draw uniform in +-5 mm each; the second half from
    ``probe.kind_states``, equal shares in which each of the model's
    contact kinds touches (some through a link offset that lowers the hand
    or the object onto the table or the floor, or carries relocate's ball
    onto the hand); and the controls of ``n_chain`` chained steps (numpy
    seed 0, torch seed 0)."""
    import numpy as np
    import torch

    model, dev = env.model, env.device
    rng = np.random.default_rng(0)

    def rand_ctrl():
        return torch.as_tensor(rng.uniform(-1, 1, (model.nu, full)), dtype=torch.float32, device=dev)

    state, _ = env.reset(full, torch.Generator(device=dev).manual_seed(0))
    for _ in range(warm_steps):
        state, *_ = env.step(state, rand_ctrl().T)
    q0, qd0 = state.q.T.contiguous(), state.qd.T.contiguous()
    delta = _offsets_and_kind_states(model, q0, qd0, rng,
                                     state.link_delta.reshape(full, -1).T)
    return q0, qd0, delta, [rand_ctrl() for _ in range(n_chain)]


def _offsets_and_kind_states(model, q0, qd0, rng, scene=None):
    """The link offsets of ``adroit_states`` and ``hammer_states``: the
    first half of the batch keeps its states and has every link offset by
    its ``scene`` offset (``(3 nlink, full)``, or none) plus a draw uniform
    in +-5 mm; the second half's states (written into ``q0`` and ``qd0``)
    and offsets come from ``probe.kind_states``, equal shares per contact
    kind of the model."""
    import torch

    from mjrl_tpu_torch.physics import probe
    from mjrl_tpu_torch.physics.tables import pair_groups

    full, dev = q0.shape[1], q0.device
    half = full // 2
    delta = torch.zeros(3 * model.nlink, full, device=dev)
    delta[:, :half] = torch.as_tensor(rng.uniform(-0.005, 0.005, (3 * model.nlink, half)),
                                      dtype=torch.float32, device=dev)
    if scene is not None:
        delta[:, :half] = scene[:, :half] + delta[:, :half]
    n_kind = -(-(full - half) // len(pair_groups(model).kinds))
    kq, kqd, kd = probe.kind_states(model, n_kind, rng)
    q0[:, half:] = torch.as_tensor(kq[:, : full - half], device=dev)
    qd0[:, half:] = torch.as_tensor(kqd[:, : full - half], device=dev)
    delta[:, half:] = torch.as_tensor(kd[:, : full - half], device=dev)
    return delta


def engine_row_env(row, device=None):
    """The env of ``ENGINE_ROWS``' ``row`` (on the card by default)."""
    from mjrl_tpu_torch.envs import make

    _, name, kwargs, _ = next(r for r in ENGINE_ROWS if r[0] == row)
    horizon = {"ant": HORIZON, "hopper": HOPPER_HORIZON, "adroit_pen": PEN_HORIZON}[name]
    return make(name, horizon=horizon, **kwargs, **({} if device is None else {"device": device}))


def engine_row_states(row, env, full):
    """``(q, qd, link_delta or None, ctrl)`` batch-last: the states of the
    phase that holds ``row``'s kernel against the plain version (ant: phase
    2's, hopper Newton: phase 8's folded ones, pen: ``adroit_states`` of
    phases 11 and 12) and the control of one step."""
    if row in ("pen", "pen_newton"):
        q, qd, delta, ctrls = adroit_states(env, full, 1)
        return q, qd, delta, ctrls[0]
    q, qd, ctrls = start_states(env, full, 1, fold=row == "hopper_newton")
    return q, qd, None, ctrls[0]


def engine_control_step(model, frames, q, qd, ctrl, delta=None):
    """One control step of the per-env engine through the frame stepper
    (``use_soa=False``), batch-last in and out."""
    from mjrl_tpu_torch.physics.dispatch import make_frame_stepper

    step = make_frame_stepper(model, frames, with_link_delta=delta is not None, use_soa=False)
    assert step.path == "engine"
    args = [q.T.contiguous(), qd.T.contiguous(), ctrl.T.contiguous()]
    if delta is not None:
        args.append(delta.T.reshape(q.shape[1], model.nlink, 3).contiguous())
    q2, qd2 = step(*args)
    return q2.T, qd2.T


def pen_train_states(env, full, n_chain, steps=50):
    """As ``adroit_states``, from the training path: the states after
    ``steps`` control steps from reset under a (64, 64) GaussianMLP policy
    at its seeded init (torch seed 0; its actions drawn with numpy seed 0),
    their link offsets (the env's own, zeros for pen), and as the controls
    of ``n_chain`` chained steps the env's scaled actions drawn at the last
    state."""
    import numpy as np
    import torch

    from mjrl_tpu_torch.models import GaussianMLP

    dev = env.device
    rng = np.random.default_rng(0)
    policy = GaussianMLP(env.spec, hidden_sizes=(64, 64),
                         generator=torch.Generator().manual_seed(0)).to(dev)

    @torch.no_grad()
    def action(obs):
        mean, log_std = policy(obs)
        noise = torch.as_tensor(rng.standard_normal(tuple(mean.shape)), dtype=torch.float32,
                                device=dev)
        return mean + torch.exp(log_std) * noise

    state, obs = env.reset(full, torch.Generator(device=dev).manual_seed(0))
    for _ in range(steps):
        state, obs, *_ = env.step(state, action(obs))
    delta = state.link_delta.reshape(full, -1).T.contiguous()
    ctrls = [env._scaled_ctrl(action(obs)).T.contiguous() for _ in range(n_chain)]
    return state.q.T.contiguous(), state.qd.T.contiguous(), delta, ctrls


def hammer_states(model, kernel, full, n_chain, warm_steps=10):
    """As ``adroit_states``, for an Adroit model without its env (the model
    and K3 alone; tools/torch_kernel_times.py times K3 on it against a
    checkout that has no hammer env): the first half from the default pose
    after ``warm_steps``
    control steps of K3 under random controls (uniform in +-1, which the
    servos clamp to their ranges), each link then offset by a draw uniform
    in +-5 mm; the second half from ``probe.kind_states``, equal shares in
    which each of hammer's five contact kinds touches; and the controls of
    ``n_chain`` chained steps (numpy seed 0), all on the card."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    frames = 5  # the Adroit envs' frame_skip

    def rand_ctrl():
        return torch.as_tensor(rng.uniform(-1, 1, (model.nu, full)), dtype=torch.float32, device=dev)

    q0 = torch.as_tensor(np.asarray(model.default_qpos, np.float32), device=dev)[:, None]
    q0, qd0 = q0.repeat(1, full).contiguous(), torch.zeros(model.nv, full, device=dev)
    for _ in range(warm_steps):
        q0, qd0 = kernel(model, q0, qd0, rand_ctrl(), frames)
    delta = _offsets_and_kind_states(model, q0, qd0, rng)
    return q0, qd0, delta, [rand_ctrl() for _ in range(n_chain)]


def check_wide(tag, kernel, model, frames, states, wide, ops, label=""):
    """K3's or K4's launch at ``wide`` envs on ``states`` (``(q, qd,
    link_delta, ctrl)`` at a batch that divides ``wide``, held against the
    plain version before) repeated: its results must be bit for bit the
    smaller batch's repeated (each env is one warp on its own inputs);
    returns them with its warps per block, time and, where ``ops`` (f32
    operations per env-substep) is given, bound; ``label`` starts each
    printed line after the tag."""
    import torch

    from mjrl_tpu_torch.physics.pkernel import size_class

    q0, qd0, d0, ctrl = states
    full = q0.shape[1]
    reps, n_sub = wide // full, frames * model.n_substeps
    want = kernel(model, q0, qd0, ctrl, frames, link_delta=d0)
    q, qd, d, c = (x.repeat(1, reps).contiguous() for x in (q0, qd0, d0, ctrl))
    got = kernel(model, q, qd, c, frames, link_delta=d)
    kernel.check()
    same = all(torch.equal(_bits(g), _bits(w.repeat(1, reps))) for g, w in zip(got, want))
    warps = kernel.launch_warps(size_class(model), wide, q.device)
    print(f"[{tag}] {label}B={wide} ({warps} warps per block) one control step from B={full}'s "
          f"states repeated: q and qd {'bit for bit' if same else 'DIFFER from'} B={full}'s "
          f"repeated")
    if not same:
        raise RuntimeError(f"{tag}: {kernel.name} at B={wide} disagrees with its B={full} "
                           f"results on the same states")
    ms = _cuda_ms(lambda: kernel(model, q, qd, c, frames, link_delta=d), 20)
    out = dict(batch=wide, ms=ms, warps_per_block=warps, bit_for_bit_as_full_batch=same)
    what = ""
    if ops is not None:
        out["bound_ms"], out["bound_by"] = _bound_ms(model, n_sub, ops,
                                                     kernel.tables(model, q.device), wide,
                                                     extra_rows=3 * model.nlink)
        what = f", bound {out['bound_ms']:.5f} ms by {out['bound_by']}"
    print(f"[{tag}] {label}B={wide} (B={full}'s states repeated) one control step: "
          f"{kernel.name} {ms:.4f} ms{what}")
    return out


def phase_k3(tag, model, frames, kernel, states, batches, tol, wide=None):
    """Holds K3 against the plain version on an Adroit model over the
    chained control steps of ``states`` (``(q, qd, link_delta, ctrls)`` at
    the full batch, ``adroit_states``') at each batch
    size of ``batches`` (the first the full one), with their link offsets;
    ``tol`` bounds each step's max |err| of q and qd; each of the model's
    contact kinds must touch (a point at depth > 0) in some env-step.
    Checks that K3's launches are repeatable (``check_repeatable``); both
    times and the bound at the full batch, and with ``wide`` (a multiple of
    it) K3 at that batch on the full batch's states repeated: its results
    bit for bit the full batch's repeated, its time and bound."""
    import torch

    from mjrl_tpu_torch.physics import probe, soa

    q0, qd0, d0, ctrls = states
    full, n_chain = batches[0], len(ctrls)
    max_err, kind_steps = 0.0, {}
    for B in batches:
        q, qd, d = (x[:, :B].contiguous() for x in (q0, qd0, d0))
        worst = {"q": 0.0, "qd": 0.0}
        kind_steps = {}
        for step, ctrl in enumerate(ctrls):
            ctrl = ctrl[:, :B].contiguous()
            for k, depth in probe.kind_depth(model, q, d).items():
                kind_steps[k] = kind_steps.get(k, 0) + int((depth > 0).sum())
            kq, kqd = kernel(model, q, qd, ctrl, frames, link_delta=d)
            pq, pqd = soa.multistep(model, q, qd, ctrl, frames, link_delta=d)
            torch.cuda.synchronize()
            for name, got, want in (("q", kq, pq), ("qd", kqd, pqd)):
                if not bool(torch.isfinite(want).all()):
                    raise RuntimeError(f"{tag}: plain {name} not finite at B={B}")
                err = float((got - want).abs().max())
                worst[name] = max(worst[name], err)
                if step == 0:
                    print(f"[{tag}] B={B} one control step {name}: max|err|={err:.3e} "
                          f"tol={tol[name]:.0e}")
            q, qd = kq, kqd
        for name in ("q", "qd"):
            ok = worst[name] <= tol[name]
            max_err = max(max_err, worst[name])
            print(f"[{tag}] B={B} {n_chain} chained control steps {name}: max per-step "
                  f"|err|={worst[name]:.3e} tol={tol[name]:.0e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{tag} disagrees with the plain version: {name} at B={B}")
        for k, n in kind_steps.items():
            print(f"[{tag}] B={B} a {k} point at depth > 0 in {n} of {n_chain * B} env-steps")
            if n == 0:
                raise RuntimeError(f"{tag}: no {k} contact at B={B}")
    ctrl = ctrls[0]
    warps = check_repeatable(tag, kernel, model, q0, qd0, ctrl, frames, link_delta=d0)
    for _ in range(3):
        kernel(model, q0, qd0, ctrl, frames, link_delta=d0)
    ms = _cuda_ms(lambda: kernel(model, q0, qd0, ctrl, frames, link_delta=d0), 20)
    soa.multistep(model, q0, qd0, ctrl, frames, link_delta=d0)
    plain_ms = _cuda_ms(lambda: soa.multistep(model, q0, qd0, ctrl, frames, link_delta=d0), 2)
    ops = _f32_ops_per_env_substep(model, q0[:, :1], qd0[:, :1], ctrl[:, :1], d0[:, :1])
    n_sub = frames * model.n_substeps
    bound_ms, bound_by = _bound_ms(model, n_sub, ops, kernel.tables(model, q0.device), full,
                                   extra_rows=3 * model.nlink)
    print(f"[{tag}] B={full} one control step ({n_sub} substeps): {kernel.name} {ms:.4f} ms, "
          f"plain {plain_ms:.2f} ms, bound {bound_ms:.5f} ms by {bound_by} "
          f"({ops:.0f} f32 operations per env-substep)")
    out = dict(max_abs_err=max_err, kind_env_steps=kind_steps, warps_per_block=warps, ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    if wide:
        out["wide"] = check_wide(tag, kernel, model, frames, (q0, qd0, d0, ctrl), wide, ops)
    return out


FACETS = ("facets_1", "facets_4", "facets_6")


def phase_k4(tag, env, kernel, n_chain, batches, tol, tol_quantile, train_states=False,
             wide=None, bound=True, plain_on_cpu=False, replay=False):
    """Holds K4 against the plain version on an Adroit env with the Newton
    solver over ``n_chain`` chained control steps at each batch size of
    ``batches`` (the first the full one), from ``adroit_states`` (half the
    batch warmed by K4) with their link offsets; ``tol`` bounds each step's
    max |err| of q and qd, ``tol_quantile`` the HUMANOID_QUANTILE quantile
    of the per env-step max |err|. At each step's entry state it counts the
    env-steps that hold a row of each of the model's contact kinds (its
    ``pair_groups``), of each facet count (condim 1, 3, 4: 1, 4, 6 facets)
    and of a joint limit, and fails if a kind holds none (with
    ``train_states``, pen's full check, also if a facet count or the
    limits do); the rows held per env (mean, max); the envs whose line
    search picked another fraction than the plain version's (with
    ``replay``, the plain version steps by K4's fractions, which takes the
    line search's ties out of the comparison, and a flip is a fraction
    that the plain version would have picked otherwise at K4's iterate);
    and K4's overflow counter, which must stay 0. With ``train_states`` the same for
    one control step at the full batch from ``pen_train_states`` (the
    training path's states), without the counts that need every kind. On
    each state set: K4's results bit for bit the same over two launches and
    with 1, 3 and the most warps (envs) per block (a missing
    __syncwarp() would let a lane read what another has not yet written,
    which shows as results that change from run to run or with the block's
    shape); K4's time (CUDA events), the plain version's (its first step of
    the check at the full batch, host clock) and, with ``bound``, the bound
    at the full batch; with ``wide`` (a multiple of it), K4 at that batch on
    the full batch's states repeated: its results bit for bit the full
    batch's repeated, its time (and bound). With ``plain_on_cpu`` the plain
    version runs on the CPU from the same inputs (a third of its time on
    the card for door's, hammer's and relocate's rows)."""
    import torch

    from mjrl_tpu_torch.physics import probe, soa
    from mjrl_tpu_torch.physics.pkernel import size_class
    from mjrl_tpu_torch.physics.tables import pair_groups

    model, dev, frames = env.model, env.device, env.frame_skip
    n_sub, iters = frames * model.n_substeps, int(model.solver_iters)
    size, full = size_class(model), batches[0]
    kinds = tuple(k for k, _ in pair_groups(model).kinds)
    most = kernel.warps_per_block(size)
    at_k4s = " at K4's iterates (K4's fractions replayed)" if replay else ""
    kernel.check()
    result = {"overflow": 0}
    sets = [(f"{env.task}_states", adroit_states, n_chain, batches)]
    if train_states:
        sets.append((f"{env.task}_train_states", pen_train_states, 1, batches[:1]))
    for label, states, chain, sizes in sets:
        q0, qd0, d0, ctrls = states(env, full, chain)
        max_err, quantile_err, flips, held_all, lim_all = 0.0, 0.0, 0, [], []
        for B in sizes:
            q, qd, d = (x[:, :B].contiguous() for x in (q0, qd0, d0))
            worst = {"q": 0.0, "qd": 0.0}
            per_env = {"q": [], "qd": []}
            counts = dict.fromkeys((*kinds, *FACETS, "limits"), 0)
            held = []
            flipped = torch.zeros(B, dtype=torch.bool, device=dev)
            flipped_first = torch.zeros(B, dtype=torch.bool, device=dev)
            for step, ctrl in enumerate(ctrls):
                ctrl = ctrl[:, :B].contiguous()
                rows = probe.held_rows(model, q, d)
                for k in counts:
                    counts[k] += int((rows[k] > 0).sum())
                held.append(rows["contacts"].float())
                lim_all.append(rows["limits"].float())
                picks = torch.full((n_sub * iters, B), -1, dtype=torch.int32, device=dev)
                plain_picks = []
                kq, kqd = kernel(model, q, qd, ctrl, frames, link_delta=d, picks=picks)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                on = torch.device("cpu") if plain_on_cpu else dev
                pq, pqd = soa.multistep(model, q.to(on), qd.to(on), ctrl.to(on), frames,
                                        picks=plain_picks, link_delta=d.to(on),
                                        replay=picks.to(on) if replay else None)
                pq, pqd = pq.to(dev), pqd.to(dev)
                torch.cuda.synchronize()
                if B == full and step == 0:
                    plain_ms = (time.perf_counter() - t0) * 1e3
                differ = picks != torch.cat(plain_picks).to(dev)
                flipped |= differ.any(dim=0)
                flipped_first |= differ[::iters].any(dim=0)
                for name, got, want in (("q", kq, pq), ("qd", kqd, pqd)):
                    if not bool(torch.isfinite(want).all()):
                        raise RuntimeError(f"{tag}: plain {name} not finite at B={B}")
                    per_env[name].append((got - want).abs().amax(dim=0))
                    err = float(per_env[name][-1].max())
                    worst[name] = max(worst[name], err)
                    if step == 0:
                        print(f"[{tag}] {label} B={B} one control step {name}: "
                              f"max|err|={err:.3e} tol={tol[name]:.0e}")
                q, qd = kq, kqd
            kernel.check()  # raises on an env-substep with more rows than MAX_HELD
            for name in ("q", "qd"):
                quant = float(torch.quantile(torch.cat(per_env[name]), HUMANOID_QUANTILE))
                ok = worst[name] <= tol[name] and quant <= tol_quantile[name]
                max_err = max(max_err, worst[name])
                quantile_err = max(quantile_err, quant)
                print(f"[{tag}] {label} B={B} {len(ctrls)} chained control steps "
                      f"{name}: max per-step |err|={worst[name]:.3e} tol={tol[name]:.0e}, "
                      f"{HUMANOID_QUANTILE:.0%} quantile of the per env-step "
                      f"|err|={quant:.3e} tol={tol_quantile[name]:.0e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise RuntimeError(f"{tag} disagrees with the plain version: {name} at "
                                       f"B={B} from {label}")
            needed = kinds + ((*FACETS, "limits") if train_states else ())
            for k, n in counts.items():
                print(f"[{tag}] {label} B={B} a held {k} row in {n} of "
                      f"{len(ctrls) * B} env-steps")
                if n == 0 and states is adroit_states and k in needed:
                    raise RuntimeError(f"{tag}: no held {k} row at B={B}")
            held = torch.stack(held)
            held_all.append(held.reshape(-1))
            flips += int(flipped.sum())
            print(f"[{tag}] {label} B={B} contact rows inside their margin per "
                  f"env-step: mean {float(held.mean()):.3f}, max {int(held.max())} (the build "
                  f"holds {kernel.build(size).newton_layout['MAX_HELD']}); overflow "
                  f"counter 0")
            print(f"[{tag}] {label} B={B} envs with another line-search fraction in "
                  f"some iteration{at_k4s}: {int(flipped.sum())} of {B}; in a substep's "
                  f"first iteration: {int(flipped_first.sum())}")
        ctrl = ctrls[0]
        runs = {}
        for run, warps in (("first", None), ("second", None), ("1 warp per block", 1),
                           ("3 warps per block (a ragged last block)", min(3, most)),
                           (f"{most} warps per block", most)):
            picks = torch.full((n_sub * iters, full), -1, dtype=torch.int32, device=dev)
            runs[run] = (*kernel(model, q0, qd0, ctrl, frames, link_delta=d0, picks=picks,
                                 warps_per_block=warps), picks)
        torch.cuda.synchronize()
        for run, out in runs.items():
            same = all(torch.equal(a, b) for a, b in zip(out, runs["first"]))
            print(f"[{tag}] {label} B={full} launch with {run}: q, qd and picks "
                  f"{'bit for bit as the first launch' if same else 'DIFFER'}")
            if not same:
                raise RuntimeError(f"{tag}: K4's results change between launches ({run})")
        for _ in range(3):
            kernel(model, q0, qd0, ctrl, frames, link_delta=d0)
        ms = _cuda_ms(lambda: kernel(model, q0, qd0, ctrl, frames, link_delta=d0), 20)
        kernel.check()
        held = torch.cat(held_all)
        r = dict(max_abs_err=max_err, quantile=HUMANOID_QUANTILE, quantile_abs_err=quantile_err,
                 held_rows_mean=float(held.mean()), held_rows_max=int(held.max()), ms=ms,
                 plain_ms=plain_ms, warps_per_block=kernel.launch_warps(size, full, dev),
                 most_warps_per_block=most)
        ops, what = None, ""
        if bound:
            ops = _newton_op_count(model, q0, qd0, ctrl, float(held.mean()),
                                   float(torch.cat(lim_all).mean()), d0)
            r["bound_ms"], r["bound_by"] = _bound_ms(model, n_sub, ops, kernel.tables(model, dev),
                                                     full, extra_rows=3 * model.nlink)
            what = (f", bound {r['bound_ms']:.5f} ms by {r['bound_by']} ({ops:.0f} f32 "
                    f"operations per env-substep)")
        print(f"[{tag}] {label} B={full} one control step ({n_sub} substeps): "
              f"{kernel.name} {ms:.4f} ms, plain {plain_ms:.2f} ms{what}")
        if wide:
            r["wide"] = check_wide(tag, kernel, model, frames, (q0, qd0, d0, ctrl), wide, ops,
                                   label=f"{label} ")
        if states is adroit_states:
            result.update(r, env_steps=counts, line_search_flips=flips)
        else:
            result["train_states"] = dict(r, line_search_flips=flips)
    return result


def phase_poses(kernel, batch):
    """The pose kernel (phase 12's last part, see the module's docstring)
    on each of ``POSE_TASKS`` with the Newton solver at ``batch`` envs and
    at ``batch - 2`` (a ragged last block): reset, ``POSE_WARM_STEPS``
    control steps of random actions through K4, so that the env's ``q`` is
    the transposed view of K4's batch-last output, and the links offset by
    the reset's plus a draw uniform in +-5 mm, given as a transposed view
    too. Its link positions, orientations and site positions against the
    plain version's (``POSES.plain``: physics/engine.py
    ``forward_kinematics`` + ``site_positions``) on the card within
    ``POSE_TOL``, the world sites (link -1) equal, every output finite and
    bit for bit the same over two launches. Its device time per launch
    (``torch.profiler``), the stream's time per call back to back and the
    plain version's (CUDA events: both paced by the host where it issues
    the calls slower than the card runs them), and the bound: the larger
    of the bytes it moves (q and offsets in, poses and sites out, its
    tables) over 3.35 TB/s and the plain version's f32 operations over 67
    TFLOP/s. Returns each task's results."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mjrl_tpu_torch.envs import make

    result = {}
    for task in POSE_TASKS:
        tag = f"poses {task}"
        env = make(f"adroit_{task}", constraint_solver="newton")
        model, dev = env.model, env.device
        if env._frame_step.path != "K4" or not env._poses_on_kernel:
            raise RuntimeError(f"{tag}: the env runs {env._frame_step.path}, pose kernel "
                               f"{env._poses_on_kernel}")
        gen = torch.Generator(device=dev).manual_seed(0)
        st, _ = env.reset(batch, gen)
        for _ in range(POSE_WARM_STEPS):
            st = env.step(st, torch.rand(batch, model.nu, device=dev, generator=gen) * 2 - 1)[0]
        env.check()
        q = st.q
        offsets = st.link_delta + (torch.rand(st.link_delta.shape, device=dev, generator=gen)
                                   - 0.5) * 1e-2
        delta = offsets.reshape(batch, -1).T.contiguous().T.reshape(batch, model.nlink, 3)
        if q.is_contiguous() or delta.is_contiguous():
            raise RuntimeError(f"{tag}: q and the offsets must be transposed views")
        world = torch.as_tensor(np.asarray(model.site_link) < 0, device=dev)
        r = {"batch": batch, "q_strides": list(q.stride())}
        for B in (batch, batch - 2):
            got = kernel(model, q[:B], delta[:B])
            again = kernel(model, q[:B], delta[:B])
            want = kernel.plain(model, q[:B], delta[:B])
            errs = {name: float((a - b).abs().max())
                    for name, a, b in zip(("pos", "quat", "sites"), got, want)}
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            world_equal = bool(torch.equal(got[2][:, world], want[2][:, world]))
            finite = all(bool(torch.isfinite(x).all()) for x in got)
            ok = max(errs.values()) <= POSE_TOL and same and world_equal and finite
            print(f"[{tag}] B={B} max|err| pos {errs['pos']:.3e}, quat {errs['quat']:.3e}, "
                  f"sites {errs['sites']:.3e} (tol {POSE_TOL:.0e}); {int(world.sum())} world "
                  f"sites {'equal' if world_equal else 'DIFFER'}; two launches "
                  f"{'bit for bit' if same else 'DIFFER'}; finite {finite} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{tag}: the pose kernel disagrees with the plain version at "
                                   f"B={B}")
            if B == batch:
                r["max_abs_err"] = max(errs.values())
                r.update({f"{name}_max_abs_err": e for name, e in errs.items()})
        for _ in range(3):
            kernel(model, q, delta)
        r["stream_ms"] = _cuda_ms(lambda: kernel(model, q, delta), 200)
        r["plain_ms"] = _cuda_ms(lambda: kernel.plain(model, q, delta), 20)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                kernel(model, q, delta)
            torch.cuda.synchronize()
        times = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA and "mj_poses_kernel" in e.name]
        r["ms"] = sum(times) / len(times) * 1e-3 if times else None
        nsite = len(model.site_link)
        io = batch * (model.nq + 3 * model.nlink + 7 * model.nlink + 3 * nsite) * 4
        t_bytes = (io + sum(t.numel() * 4 for t in kernel.tables(model, dev))) / HBM_BYTES_PER_S
        ops = _f32_ops(lambda: kernel.plain(model, q.cpu(), delta.cpu()))
        t_ops = ops / F32_OPS_PER_S
        r["bound_ms"] = max(t_bytes, t_ops) * 1e3
        r["bound_by"] = "operations" if t_ops > t_bytes else "bytes"
        device = "not in the profiler's trace" if r["ms"] is None else f"{r['ms']:.5f} ms"
        print(f"[{tag}] B={batch} {kernel.name}: device {device} a launch, stream "
              f"{r['stream_ms']:.4f} ms a call back to back, plain {r['plain_ms']:.4f} ms a call; "
              f"bound {r['bound_ms']:.5f} ms by {r['bound_by']} ({ops / batch:.0f} f32 "
              f"operations per env)")
        result[task] = r
    return result


def _bits(x):
    """A float32 tensor's bits (so that equal NaNs compare equal), or the
    tensor."""
    import torch

    return x.view(torch.int32) if x.is_floating_point() else x


def check_repeatable(tag, kernel, model, q, qd, ctrl, frames, link_delta=None):
    """Launches ``kernel`` (K1, K2 or K3, with K3's ``link_delta``) from the
    same inputs twice with its default warps per block and once each with 1
    and with the most a block holds, and fails unless q, qd and, for K2,
    the picks are bit for bit the same: a missing __syncwarp() would let a
    lane read what another has not yet written, which shows as results
    that change from run to run or with the block's shape. Returns the
    default warps per block."""
    import torch

    from mjrl_tpu_torch.physics.pkernel import size_class

    size, B = size_class(model), q.shape[1]
    most, default = kernel.warps_per_block(size), kernel.launch_warps(size, B, q.device)
    runs = {}
    for label, warps in (("first", None), ("second", None), ("1 warp per block", 1),
                         (f"{most} warps per block", most)):
        kw = {}
        if model.constraint_solver == "newton":
            kw["picks"] = torch.full((frames * model.n_substeps * model.solver_iters, B), -1,
                                     dtype=torch.int32, device=q.device)
        delta = {} if link_delta is None else {"link_delta": link_delta}
        runs[label] = (*kernel(model, q, qd, ctrl, frames, warps_per_block=warps, **kw, **delta),
                       *kw.values())
    torch.cuda.synchronize()
    for label, out in runs.items():
        same = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(out, runs["first"]))
        what = "q, qd and picks" if len(out) > 2 else "q and qd"
        print(f"[{tag}] B={B} launch with {label} (default {default} warps per block): {what} "
              f"{'bit for bit as the first launch' if same else 'DIFFER'}")
        if not same:
            raise RuntimeError(f"{tag}: {kernel.name}'s results change between launches ({label})")
    return default


def phase_kernel_vs_plain(tag, env, kernel, n_chain, batches, warm_steps=10, warm_scale=1.0,
                          fold=False, timed=True, tol=None, kinds=(), quantile=None):
    """Holds ``kernel`` against the plain version over ``n_chain`` chained
    control steps at each batch size of ``batches`` (the first the full
    one), from ``start_states``; ``tol`` (default: TOL of the kernel)
    bounds each step's max |err|; every contact kind of ``kinds`` must have
    a point at depth > 0 in some env-step. With ``quantile``, ``tol``
    bounds that quantile of the per env-step max |err| instead of the max
    (the max and the env-steps above ``tol`` are printed), over all
    env-steps and, for each kind of ``kinds``, over the env-steps where
    that kind touches, so that a fault confined to a rare kind cannot hide
    in the quantile's tail. ``timed``: both times and the bound at the
    full batch."""
    import torch

    from mjrl_tpu_torch.physics import probe, soa

    model, dev, frames = env.model, env.device, env.frame_skip
    newton = model.constraint_solver == "newton"
    tol = tol or TOL["K2" if newton else "K1"]
    n_sub = frames * model.n_substeps
    full = batches[0]

    def in_contact(q):
        pos, quat = soa._fk(model, q)
        cands = soa._contact_candidates(model, pos, quat)
        if not cands:
            return 0
        return int((torch.cat([c.depth for c in cands]) > 0).any(dim=0).sum())

    q0, qd0, ctrls = start_states(env, full, n_chain, warm_steps, warm_scale, fold)
    max_err, quantile_err, flips, held = 0.0, 0.0, 0, []
    held_pairs = 0
    for B in batches:
        q, qd = q0[:, :B].contiguous(), qd0[:, :B].contiguous()
        worst = {"q": 0.0, "qd": 0.0}
        contact = pair_contact = 0
        kind_steps = dict.fromkeys(kinds, 0)
        kind_masks = {k: [] for k in kinds}
        per_env = {"q": [], "qd": []}
        flipped = torch.zeros(B, dtype=torch.bool, device=dev)
        flipped_first = torch.zeros(B, dtype=torch.bool, device=dev)
        for step, ctrl in enumerate(ctrls):
            ctrl = ctrl[:, :B].contiguous()
            kw, plain_picks = {}, None
            if newton:
                held.append(_held_rows(model, q))
                if fold:
                    pair_contact += int((probe.held_contact_rows(model, q, between_links=True) > 0)
                                        .sum())
                kw["picks"] = torch.full((n_sub * model.solver_iters, B), -1, dtype=torch.int32,
                                         device=dev)
                plain_picks = []
            else:
                contact += in_contact(q)
                if kinds:
                    depth = probe.kind_depth(model, q)
                    for k in kinds:
                        kind_masks[k].append(depth[k] > 0)
                        kind_steps[k] += int(kind_masks[k][-1].sum())
                if fold:
                    pair_contact += int((probe.link_pair_depth(model, q) > 0).sum())
            kq, kqd = kernel(model, q, qd, ctrl, frames, **kw)
            pq, pqd = soa.multistep(model, q, qd, ctrl, frames, picks=plain_picks)
            torch.cuda.synchronize()
            if newton:
                differ = kw["picks"] != torch.cat(plain_picks)
                flipped |= differ.any(dim=0)
                flipped_first |= differ[::model.solver_iters].any(dim=0)
            for name, got, want in (("q", kq, pq), ("qd", kqd, pqd)):
                if not bool(torch.isfinite(want).all()):
                    raise RuntimeError(f"{tag}: plain {name} not finite at B={B}")
                per_env[name].append((got - want).abs().amax(dim=0))
                err = float(per_env[name][-1].max())
                worst[name] = max(worst[name], err)
                if step == 0:
                    print(f"[{tag}] B={B} one control step {name}: max|err|={err:.3e} "
                          f"tol={tol[name]:.0e}")
            q, qd = kq, kqd
        for name in ("q", "qd"):
            held_err, what = worst[name], "max per-step"
            if quantile is not None:
                e = torch.cat(per_env[name])
                held_err = float(torch.quantile(e, quantile))
                what = f"{quantile:.0%} quantile of the per env-step"
                print(f"[{tag}] B={B} {name}: max |err| {worst[name]:.3e}, above tol in "
                      f"{int((e > tol[name]).sum())} of {e.numel()} env-steps")
            ok = held_err <= tol[name]
            max_err = max(max_err, worst[name])
            quantile_err = max(quantile_err, held_err)
            print(f"[{tag}] B={B} {n_chain} chained control steps {name}: {what} "
                  f"|err|={held_err:.3e} tol={tol[name]:.0e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{tag} disagrees with the plain version: {name} at B={B}")
            if quantile is not None:
                for k in kinds:
                    e = torch.cat(per_env[name])[torch.cat(kind_masks[k])]
                    if e.numel() == 0:
                        continue
                    held_k = float(torch.quantile(e, quantile))
                    ok = held_k <= tol[name]
                    print(f"[{tag}] B={B} {name} over the {e.numel()} env-steps where {k} "
                          f"touches: {quantile:.0%} quantile |err|={held_k:.3e}, max "
                          f"{float(e.max()):.3e} tol={tol[name]:.0e} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise RuntimeError(f"{tag} disagrees with the plain version where {k} "
                                           f"touches: {name} at B={B}")
        if not newton:  # Newton feet rest inside the margin: see the rows below
            print(f"[{tag}] B={B} bodies touching the floor or each other in {contact} of "
                  f"{n_chain * B} env-steps")
        for k, n in kind_steps.items():
            print(f"[{tag}] B={B} a {k} point at depth > 0 in {n} of {n_chain * B} env-steps")
            if n == 0:
                raise RuntimeError(f"{tag}: no {k} contact at B={B}")
        if fold:
            what = ("a held row between two moving links" if newton
                    else "a capsule-capsule candidate at depth > 0")
            print(f"[{tag}] B={B} {what} in {pair_contact} of {n_chain * B} env-steps")
            if pair_contact == 0:
                raise RuntimeError(f"{tag}: no {what} at B={B}")
            held_pairs += pair_contact
        if newton:
            cand = sum(h[0] for h in held[-n_chain:]) / n_chain
            lim = sum(h[1] for h in held[-n_chain:]) / n_chain
            print(f"[{tag}] B={B} rows inside their margin per env-step: {cand:.3f} contact "
                  f"points, {lim:.3f} limits")
            flips += int(flipped.sum())
            print(f"[{tag}] B={B} envs with another line-search fraction in some iteration: "
                  f"{int(flipped.sum())} of {B}; in a substep's first iteration: "
                  f"{int(flipped_first.sum())}")
    result = dict(max_abs_err=max_err, line_search_flips=flips, link_pair_env_steps=held_pairs,
                  kind_env_steps=kind_steps,
                  warps_per_block=check_repeatable(tag, kernel, model, q0, qd0, ctrls[0], frames))
    if newton:
        kernel.check()  # raises on an env-substep with more rows than MAX_HELD
        result["overflow"] = 0
        print(f"[{tag}] held-row overflow counter 0 (the build holds "
              f"{kernel.build(0).newton_layout['MAX_HELD']} rows)")
    if quantile is not None:
        result["quantile"], result["quantile_abs_err"] = quantile, quantile_err
    if not timed:
        return result
    ctrl = ctrls[0]
    for _ in range(3):
        kernel(model, q0, qd0, ctrl, frames)
    ms = _cuda_ms(lambda: kernel(model, q0, qd0, ctrl, frames), 20)
    soa.multistep(model, q0, qd0, ctrl, frames)
    plain_ms = _cuda_ms(lambda: soa.multistep(model, q0, qd0, ctrl, frames), 2)
    if newton:
        cand = sum(h[0] for h in held) / len(held)
        lim = sum(h[1] for h in held) / len(held)
        ops = _newton_op_count(model, q0, qd0, ctrl, cand, lim)
    else:
        ops = _f32_ops_per_env_substep(model, q0[:, :1], qd0[:, :1], ctrl[:, :1])
    bound_ms, bound_by = _bound_ms(model, n_sub, ops, kernel.tables(model, dev), full)
    print(f"[{tag}] B={full} one control step ({n_sub} substeps): {kernel.name} {ms:.4f} ms, "
          f"plain {plain_ms:.2f} ms, bound {bound_ms:.5f} ms by {bound_by} "
          f"({ops:.0f} f32 operations per env-substep)")
    return dict(result, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_k2_condims(tag, env, kernel, batch):
    """K2 on ``env``'s model with every geom forced to condim 1 (one row per
    contact) and to condim 4 (six facets, torsional friction): one control
    step at ``batch``, the first half folded so a row between two moving
    links is held, the second from warmed states, against the plain
    version to K2's tolerance; the launches bit for bit the same. Returns
    the max |err| over both."""
    import copy

    import numpy as np
    import torch

    from mjrl_tpu_torch.physics import pkernel, probe, soa

    frames, dev, half = env.frame_skip, env.device, batch // 2
    rng = np.random.default_rng(0)
    fq, fqd = probe.overlapping_states(env.model, half, rng)
    wq, wqd, ctrls = start_states(env, batch - half, 1)
    q = torch.cat([torch.as_tensor(fq, device=dev), wq], dim=1).contiguous()
    qd = torch.cat([torch.as_tensor(fqd, device=dev), wqd], dim=1).contiguous()
    ctrl = torch.as_tensor(rng.uniform(-1, 1, (env.model.nu, batch)), dtype=torch.float32,
                           device=dev)
    max_err = 0.0
    for condim in (1, 4):
        model = copy.copy(env.model)
        pkernel.drop_tables(model)
        model.geom_condim = np.full(model.ngeom, condim, np.int32)
        held = int((probe.held_contact_rows(model, q) > 0).sum())
        kq, kqd = kernel(model, q, qd, ctrl, frames)
        pq, pqd = soa.multistep(model, q, qd, ctrl, frames)
        torch.cuda.synchronize()
        for name, got, want in (("q", kq, pq), ("qd", kqd, pqd)):
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            ok = err <= TOL["K2"][name]
            print(f"[{tag}] condim {condim} B={batch} one control step {name}: max|err|={err:.3e} "
                  f"tol={TOL['K2'][name]:.0e} {'ok' if ok else 'FAIL'} ({held} envs hold a "
                  f"contact row)")
            if not ok:
                raise RuntimeError(f"{tag} disagrees with the plain version at condim {condim}: "
                                   f"{name}")
        check_repeatable(f"{tag} condim {condim}", kernel, model, q, qd, ctrl, frames)
    kernel.check()
    return max_err


def _agent(env, **kw):
    import torch

    from mjrl_tpu_torch.algos import NPG
    from mjrl_tpu_torch.models import GaussianMLP, MLPBaseline

    dev = env.device
    init = torch.Generator().manual_seed(0)
    policy = GaussianMLP(env.spec, hidden_sizes=(64, 64), generator=init).to(dev)
    baseline = MLPBaseline(env.spec, epochs=2, batch_size=1024, generator=init).to(dev)
    return NPG(env, policy, baseline, normalized_step_size=0.05, num_traj=NUM_ENVS, **kw)


def phase_slice(tag, env, agent, kernel, other):
    """ITERS train steps; returns the kernel's launches over them."""
    import torch

    gen = torch.Generator(device=env.device).manual_seed(1)
    kernel.launches = other.launches = 0
    t_in_ep = None
    for it in range(ITERS):
        before = kernel.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = agent.train_step(gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = kernel.launches - before
        values = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in values.items() if not math.isfinite(v)]
        if bad:
            raise RuntimeError(f"non-finite metrics {bad}")
        if launches != HORIZON or other.launches:
            raise RuntimeError(f"iteration {it}: {launches} {kernel.name} and {other.launches} "
                               f"{other.name} launches, expected {HORIZON} and 0")
        print(f"[{tag}] iter {it}: {dt * 1e3:.1f} ms, valid {values['num_samples'] / dt:.1f} "
              f"env-steps/s, computed {NUM_ENVS * HORIZON / dt:.1f} env-steps/s, launches "
              f"{launches}, score {values['stoc_pol_mean']:.3f}, kl {values['kl_dist']:.5f}, "
              f"alpha {values['alpha']:.4f}, VF {values['VF_error_before']:.3f}->"
              f"{values['VF_error_after']:.3f}")
        carry = agent.sampler_carry
        if carry is not None:
            # rows whose episode began inside the window are mid-episode
            # at its end and go on into the next one
            t_in_ep = carry.t_in_ep.clone()
            print(f"[{tag}] iter {it}: {int((t_in_ep > 0).sum())} of {NUM_ENVS} rows carry "
                  f"t_in_ep > 0 (max {int(t_in_ep.max())}) into the next window")
    tensors = [*agent.policy.parameters(), *agent.baseline.parameters(), env.qpos0]
    state, obs = env.reset(2, gen)
    tensors += [state.q, state.qd, obs]
    if agent.sample_mode == "samples":
        if t_in_ep is None or not bool((t_in_ep > 0).any()):
            raise RuntimeError("no row carried an episode into the next window")
        c = agent.sampler_carry
        tensors += [c.state.q, c.state.qd, c.obs, c.t_in_ep, c.ep_return]
    if not all(t.is_cuda for t in tensors):
        raise RuntimeError("state, carry or parameters off the card")
    return kernel.launches


def _make_demos(config, overrides, out):
    """25 eval-mode episodes of ``config``'s initial policy (its seed's
    weights, the policy mean), at its horizon, on the card, pickled as mjrl
    path dicts into ``out``; returns the pickle's path. The card's copy of
    the repo has no ``demos/``."""
    import pickle

    import torch

    from mjrl_tpu_torch.samplers import sample_episodes
    from mjrl_tpu_torch.train import load_config
    from mjrl_tpu_torch.utils.configs import build
    from mjrl_tpu_torch.utils.demos import batch_to_paths

    cfg = load_config(ROOT / "examples" / config, [*overrides, "demo_file=null",
                                                   "algorithm=\"npg\"", "agent_kwargs={}"])
    env, policy, _, agent = build(cfg)
    gen = torch.Generator(device=env.device).manual_seed(cfg.seed)
    batch = sample_episodes(env, policy, DEMO_PATHS, agent.horizon, gen, eval_mode=True)
    path = os.path.join(out, "demos.pickle")
    with open(path, "wb") as f:
        pickle.dump(batch_to_paths(batch), f)
    return path


def phase_entry(tag, config, kernel, others, num_envs, steps, niters=(1,), overrides=(),
                record=None, poses=None):
    """Full-width iterations of ``examples/<config>`` (with ``overrides``)
    through ``mjrl_tpu_torch.train.run_job``: one call per entry of ``niters``, all
    into one temporary directory, each call after the first resuming from
    the checkpoint of the one before. Each iteration must launch ``kernel``
    ``steps`` times (``kernel`` None: point_mass, no kernel) and none of
    ``others``; a config with ``obs_norm`` adds its rollout to the first
    call, counted apart. A DAPG config first makes its demos on the card
    (``_make_demos``, counted apart); its first call runs BC, whose loss
    must fall, and no later call reruns it; its logged ``demo_coef`` must
    be ``lam_0 * lam_1**i``. On ``WARM_START_PATH`` one more call starts a
    run with ``init_policy_from`` the first directory and no BC: its first
    policy must be that checkpoint's. A config with evaluation rollouts must
    log a finite ``eval_score``. A model-based config must launch nothing
    during its imagined rollouts (counted around each), imagine
    ``img_traj x img_horizon`` steps from valid observations of the real
    batch, log a finite ``dyn_error`` under its ``DYN_ERROR_MAX`` and a
    ``running_score`` equal to ``stoc_pol_mean`` at its first iteration,
    keep its ensemble on the card, and resume it as the checkpoint holds it.
    ``poses``: the pose kernel, where the path's env runs it: each
    iteration, and the demos' and the warm start's rollouts, must launch it
    ``steps + 1`` times (each control step and the episode's reset).
    Returns the kernel's launches over the phase (the demos' aside); the
    log's rows go into ``record[tag]`` where given."""
    import torch

    from mjrl_tpu_torch import train
    from mjrl_tpu_torch.algos.model_npg import ModelAccelNPG
    from mjrl_tpu_torch.train import load_config, run_job

    def launches():
        return kernel.launches if kernel is not None else 0

    def pose_launches():
        return poses.launches if poses is not None else 0

    per_iter = steps if kernel is not None else 0
    pose_per_iter = steps + 1 if poses is not None else 0

    for k in (kernel, poses, *others):
        if k is not None:
            k.launches = 0
    per_call, obs_norm, carried, bc, starts = [], [], [], [], []
    pose_per_call, pose_demos = [], None
    obs_norm_init, warm_start = train.obs_norm_init, train.warm_start
    train_agent = train.train_agent

    def counted_obs_norm_init(*args, **kwargs):
        before = launches()
        obs_norm_init(*args, **kwargs)
        obs_norm.append(launches() - before)

    def counted_warm_start(*args, **kwargs):
        before = launches()
        metrics = warm_start(*args, **kwargs)
        bc.append((float(metrics["loss_before"]), float(metrics["loss_after"]),
                   launches() - before))
        return metrics

    def recorded_train_agent(job, agent, **kwargs):
        starts.append({k: v.clone() for k, v in agent.policy.state_dict().items()})
        return train_agent(job, agent, **kwargs)

    imagine, load_model_state = ModelAccelNPG.imagine, ModelAccelNPG.load_state_dict
    imagined, loaded = [], []

    def counted_imagine(agent, real, generator=None, noise=None):
        before = launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = imagine(agent, real, generator, noise)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        pool = real.observations[real.valid]
        nearest = torch.cdist(img.observations[:, 0], pool,
                              compute_mode="donot_use_mm_for_euclid_dist").min(dim=1).values
        imagined.append(dict(launches=launches() - before, ms=ms, shape=tuple(img.rewards.shape),
                             start_dist=float(nearest.max()),
                             valid=float(img.valid.float().mean())))
        return img

    def recorded_load(agent, state):
        load_model_state(agent, state)
        opt = agent.dynamics.optimizer.state_dict()["state"]
        loaded.append(({k: v.clone() for k, v in agent.dynamics.state_dict().items()},
                       {(i, k): v.clone() for i, st in opt.items() for k, v in st.items()}))

    demo_launches = None
    train.obs_norm_init, train.warm_start = counted_obs_norm_init, counted_warm_start
    train.train_agent = recorded_train_agent
    ModelAccelNPG.imagine, ModelAccelNPG.load_state_dict = counted_imagine, recorded_load
    try:
        with tempfile.TemporaryDirectory() as out, tempfile.TemporaryDirectory() as side:
            dapg = load_config(ROOT / "examples" / config, overrides).algorithm == "dapg"
            if dapg:
                before, before_poses = launches(), pose_launches()
                demo_file = _make_demos(config, overrides, side)
                demo_launches = launches() - before
                pose_demos = pose_launches() - before_poses
                overrides = (*overrides, f"demo_file=\"{demo_file}\"")
            for i, niter in enumerate(niters):
                before, before_poses = launches(), pose_launches()
                cfg = load_config(ROOT / "examples" / config,
                                  [*overrides, f"niter={niter}", "save_freq=1"])
                agent = run_job(cfg, out)
                per_call.append(launches() - before - (sum(obs_norm) if i == 0 else 0))
                pose_per_call.append(pose_launches() - before_poses)
                if agent.sample_mode == "samples":
                    # rows mid-episode at the window's end go on into the next
                    carried.append(int((agent.sampler_carry.t_in_ep > 0).sum()))
            done = [n - p for n, p in zip(niters, (0, *niters[:-1]))]
            want_norm = [steps] if cfg.obs_norm else []
            stray = {k.name: k.launches for k in others if k is not None and k.launches}
            if per_call != [per_iter * d for d in done] or \
                    obs_norm != want_norm or stray or demo_launches not in (None, per_iter):
                raise RuntimeError(f"{tag}: {per_call} {kernel and kernel.name} launches per call, "
                                   f"obs_norm rollout {obs_norm}, demos {demo_launches}, other "
                                   f"kernels {stray}; expected {per_iter} per iteration, "
                                   f"{want_norm} and none")
            if pose_per_call != [pose_per_iter * d for d in done] or \
                    pose_demos not in (None, pose_per_iter):
                raise RuntimeError(f"{tag}: {pose_per_call} pose kernel launches per call, demos "
                                   f"{pose_demos}; expected {pose_per_iter} per iteration")
            if poses is not None:
                print(f"[{tag}] pose kernel: {pose_per_call} launches per call, {pose_per_iter} "
                      f"per iteration" + ("" if pose_demos is None else f", demos {pose_demos}"))
            if kernel is not None:
                kernel.check()
            if obs_norm:
                print(f"[{tag}] obs_norm rollout: {obs_norm[0]} launches, policy in_scale in "
                      f"[{float(agent.policy.mlp.in_scale.min()):.4f}, "
                      f"{float(agent.policy.mlp.in_scale.max()):.4f}]")
            if dapg:
                if len(bc) != 1 or bc[0][2] or not bc[0][1] < bc[0][0]:
                    raise RuntimeError(f"{tag}: BC runs (loss before, after, launches) {bc}; "
                                       f"expected one, in the first call, its loss falling")
                print(f"[{tag}] demos: {DEMO_PATHS} eval-mode episodes of the initial policy, "
                      f"{demo_launches} launches; BC warm start: loss {bc[0][0]:.6g} -> "
                      f"{bc[0][1]:.6g}, {len(bc)} run over {len(niters)} calls")
            with open(os.path.join(out, "logs", "log.csv"), newline="") as f:
                rows = [{k: float(v) for k, v in row.items()} for row in csv.DictReader(f)]
            if len(rows) != niters[-1]:
                raise RuntimeError(f"{tag}: log.csv has {len(rows)} rows, expected {niters[-1]}")
            if record is not None:
                record[tag] = rows
            for row in rows:
                bad = [k for k, v in row.items() if not math.isfinite(v)]
                if bad:
                    raise RuntimeError(f"{tag}: non-finite logged values {bad}")
                dt = row["time_step"]
                extra = (f", backtrack_iters {row['backtrack_iters']:.0f}, step_accepted "
                         f"{row['step_accepted']:.0f}" if "backtrack_iters" in row else "")
                if "log_std_mean" in row:
                    extra += f", log_std_mean {row['log_std_mean']:.5f}"
                if dapg:
                    extra += f", demo_coef {row['demo_coef']:.6f}"
                if cfg.evaluation_rollouts:
                    extra += f", eval_score {row['eval_score']:.3f}"
                print(f"[{tag}] iter {int(row['iteration'])}: {dt * 1e3:.1f} ms, valid "
                      f"{row['steps_per_sec']:.1f} env-steps/s ({row['num_samples']:.0f} valid "
                      f"samples), computed {num_envs * steps / dt:.1f} env-steps/s, launches "
                      f"{per_iter}, score {row['stoc_pol_mean']:.3f}, running "
                      f"score {row['running_score']:.3f}, success {row['success_rate']:.2f}%, kl "
                      f"{row['kl_dist']:.5f}, alpha {row['alpha']:.6f}, VF "
                      f"{row['VF_error_before']:.3f}->{row['VF_error_after']:.3f}{extra}")
            if dapg:
                lam_0, lam_1 = cfg.agent_kwargs["lam_0"], cfg.agent_kwargs["lam_1"]
                want = [lam_0 * lam_1**i for i in range(len(rows))]
                got = [row["demo_coef"] for row in rows]
                if any(abs(g - w) > 1e-6 * w for g, w in zip(got, want)):
                    raise RuntimeError(f"{tag}: demo_coef {got}, expected {want}")
            if cfg.evaluation_rollouts and "eval_score" not in rows[0]:
                raise RuntimeError(f"{tag}: no eval_score logged")
            if isinstance(agent, ModelAccelNPG):
                check_model_path(tag, agent, out, rows, imagined, loaded, niters)
            if agent.sample_mode == "samples":
                lr = [row["alpha"] for row in rows]
                if len(lr) > 1 and not lr[1] < lr[0]:
                    raise RuntimeError(f"{tag}: the learning rate did not anneal: {lr}")
                print(f"[{tag}] rows mid-episode carried into the next window after each call "
                      f"(through the checkpoint between calls): {carried} of {num_envs}, "
                      f"t_in_ep max {int(agent.sampler_carry.t_in_ep.max())}")
                if not all(carried):
                    raise RuntimeError(f"{tag}: no row carried its episode into the next window")
            if sorted(os.listdir(os.path.join(out, "iterations"))) != [f"{n}.pt" for n in niters] or \
                    not os.path.exists(os.path.join(out, "best.pt")):
                raise RuntimeError(f"{tag}: checkpoints missing")
            state, obs = agent.env.reset(2)
            tensors = [*agent.policy.parameters(), *agent.policy.buffers(),
                       *agent.baseline.parameters(), *agent.baseline.buffers(),
                       agent.running_score, obs, *state]
            if dapg:
                tensors.append(agent.demo_batch.observations)
            if not all(t.is_cuda for t in tensors):
                raise RuntimeError(f"{tag}: state or parameters off the card")
            if tag == WARM_START_PATH:
                before, before_poses = launches(), pose_launches()
                warm = load_config(ROOT / "examples" / config, [
                    *overrides, f"init_policy_from=\"{out}\"", "bc_init=false", "niter=1",
                    "save_freq=1"])
                run_job(warm, os.path.join(side, "warm"))
                src = torch.load(os.path.join(out, "iterations", f"{niters[-1]}.pt"),
                                 weights_only=True)["policy"]
                first = starts[-1]
                same = all(first[k].is_cuda and torch.equal(first[k], v) for k, v in src.items())
                warm_poses = pose_launches() - before_poses
                if not same or len(bc) != 1 or launches() - before != per_iter or \
                        warm_poses != pose_per_iter:
                    raise RuntimeError(f"{tag}: the warm-started run's first policy equals the "
                                       f"checkpoint's: {same}; BC runs {len(bc)}; launches "
                                       f"{launches() - before}, expected {per_iter}; pose kernel "
                                       f"{warm_poses}, expected {pose_per_iter}")
                print(f"[{tag}] init_policy_from the run above (iteration {niters[-1]}), no BC: "
                      f"first policy equal to the checkpoint's on the card, {per_iter} launches")
    finally:
        train.obs_norm_init, train.warm_start = obs_norm_init, warm_start
        train.train_agent = train_agent
        ModelAccelNPG.imagine, ModelAccelNPG.load_state_dict = imagine, load_model_state
    return launches() - (demo_launches or 0)


def check_model_path(tag, agent, out, rows, imagined, loaded, niters):
    """The model-based path's checks of ``phase_entry`` (see there)."""
    import torch

    want = (agent.img_traj, agent.img_horizon)
    bad = [r for r in imagined if r["launches"] or r["shape"] != want or r["start_dist"] != 0.0]
    if len(imagined) != niters[-1] or bad:
        raise RuntimeError(f"{tag}: imagined rollouts {imagined}; expected {niters[-1]} of shape "
                           f"{want}, no launch, every start a valid real observation")
    first = rows[0]
    if not (math.isfinite(first["dyn_error"]) and first["dyn_error"] < DYN_ERROR_MAX[tag]) or \
            first["running_score"] != first["stoc_pol_mean"]:
        raise RuntimeError(f"{tag}: first iteration dyn_error {first['dyn_error']} (expected under "
                           f"{DYN_ERROR_MAX[tag]}), running_score {first['running_score']} against "
                           f"stoc_pol_mean {first['stoc_pol_mean']}")
    dyn = agent.dynamics
    moments = [v for st in dyn.optimizer.state.values() for k, v in st.items() if k != "step"]
    tensors = [*dyn.parameters(), *dyn.buffers(), *moments]
    if not moments or not all(t.is_cuda for t in tensors):
        raise RuntimeError(f"{tag}: the ensemble's state off the card")
    if len(niters) > 1:
        saved = torch.load(os.path.join(out, "iterations", f"{niters[0]}.pt"), weights_only=True)
        params, opt = loaded[0]
        saved_opt = {(i, k): v for i, st in saved["dynamics_optimizer"]["state"].items()
                     for k, v in st.items()}
        same = (len(loaded) == 1 and set(params) == set(saved["dynamics"])
                and all(params[k].is_cuda and torch.equal(params[k].cpu(), v.cpu())
                        for k, v in saved["dynamics"].items())
                and set(opt) == set(saved_opt)
                and all(torch.equal(opt[k].cpu(), v.cpu()) for k, v in saved_opt.items()))
        if not same:
            raise RuntimeError(f"{tag}: the resumed ensemble differs from the checkpoint's")
    for it, (r, row) in enumerate(zip(imagined, rows)):
        print(f"[{tag}] iter {it}: imagined {r['shape'][0]} x {r['shape'][1]} in {r['ms']:.1f} ms, "
              f"{r['launches']} launches, {100 * r['valid']:.1f}% of its steps valid, every start "
              f"a valid real observation; dyn_error {row['dyn_error']:.5f} (max "
              f"{row['dyn_error_max']:.5f}) over {row['dyn_num_pairs']:.0f} pairs")
    if len(niters) > 1:
        print(f"[{tag}] the resumed call's ensemble (parameters, normalizers, Adam moments and "
              f"count) equals checkpoint {niters[0]}'s, on the card")


def phase_breadth(others):
    """Phase 14: one iteration of each ``BREADTH_ROWS`` setting on the card
    through ``run_job``, no kernel launched."""
    from mjrl_tpu_torch.algos.npg import NPG
    from mjrl_tpu_torch.train import load_config, run_job

    for k in others:
        k.launches = 0
    hvp_mask, masks = NPG.hvp_mask, []

    def counted_mask(agent, batch, generator=None):
        mask = hvp_mask(agent, batch, generator)
        masks.append(mask)
        return mask

    NPG.hvp_mask = counted_mask
    try:
        for tag, overrides in BREADTH_ROWS:
            masks.clear()
            with tempfile.TemporaryDirectory() as out:
                cfg = load_config(ROOT / "examples" / "point_mass_npg.json",
                                  [*overrides, "niter=1", "save_freq=1"])
                agent = run_job(cfg, out)
                with open(os.path.join(out, "logs", "log.csv"), newline="") as f:
                    (row,) = [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]
            state, obs = agent.env.reset(2)
            tensors = [*agent.policy.parameters(), *agent.baseline.buffers(),
                       agent.running_score, obs, *state]
            frac = getattr(agent, "hvp_sample_frac", 1.0)
            drawn = [m for m in masks if m is not None]
            if not all(math.isfinite(v) for v in row.values()) or \
                    not all(t.is_cuda for t in tensors) or len(drawn) != int(frac < 1.0) or \
                    any(not m.is_cuda for m in drawn):
                raise RuntimeError(f"{tag}: row {row}, state on the card "
                                   f"{[t.is_cuda for t in tensors]}, FVP masks {len(drawn)}")
            print(f"[breadth] {tag}: {type(agent).__name__}, {type(agent.policy).__name__} on "
                  f"{type(agent.env).__name__}, {row['time_step'] * 1e3:.1f} ms, score "
                  f"{row['stoc_pol_mean']:.3f}, kl {row['kl_dist']:.5f}, alpha {row['alpha']:.4f}"
                  + (f", FVP mask mean {float(drawn[0].mean()):.4f}" if drawn else ""))
    finally:
        NPG.hvp_mask = hvp_mask
    stray = {k.name: k.launches for k in others if k.launches}
    if stray:
        raise RuntimeError(f"breadth: kernel launches {stray}")


def _dp_iterations(env, agent, kernel):
    """Phase 15's two ant iterations (``DP_SEEDS``) on this process's rows:
    the first's rows, metrics, launches and parameters, the second's ms."""
    import torch

    from mjrl_tpu_torch.ops.ravel import ravel
    from mjrl_tpu_torch.parallel import dist
    from mjrl_tpu_torch.samplers import sample_episodes
    from mjrl_tpu_torch.utils.train_agent import replicated_tensors

    out = {}
    for it, seed in enumerate(DP_SEEDS):
        gen = torch.Generator(device=env.device).manual_seed(seed)
        kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = sample_episodes(env, agent.policy, NUM_ENVS, HORIZON, gen)
        metrics = agent.finish_train_step(batch, generator=gen)
        values = {k: float(v) for k, v in metrics.items()}
        ms = (time.perf_counter() - t0) * 1e3
        dist.check_replicated(replicated_tensors(agent.state_dict()))
        if it == 0:
            out.update(rows={f: getattr(batch, f).cpu() for f in DP_FIELDS}, metrics=values,
                       launches=kernel.launches, envs=batch.num_envs,
                       flat=ravel(agent.params())[0].cpu())
        else:
            out.update(ms=ms, launches_2=kernel.launches)
    return out


def _dp_ant_rank(device, out_dir):
    """One rank of phase 15's ant run."""
    import torch

    from mjrl_tpu_torch.envs import make
    from mjrl_tpu_torch.parallel import dist
    from mjrl_tpu_torch.physics.pkernel import K1

    env = make("ant", horizon=HORIZON, device=device)
    res = _dp_iterations(env, _agent(env, horizon=HORIZON), K1)
    res.update(device=str(device), backend=torch.distributed.get_backend())
    torch.save(res, os.path.join(out_dir, f"rank{dist.rank()}.pt"))


def _dp_entry_rank(device, cfg, job, out_dir):
    """One rank of phase 15's humanoid PPO run: ``run_job`` in the group,
    with K1's launches counted, the obs_norm rollout's apart."""
    import torch

    from mjrl_tpu_torch import train
    from mjrl_tpu_torch.parallel import dist
    from mjrl_tpu_torch.physics.pkernel import K1

    obs_norm, counted = [], train.obs_norm_init

    def counted_obs_norm_init(*args, **kwargs):
        before = K1.launches
        counted(*args, **kwargs)
        obs_norm.append(K1.launches - before)

    train.obs_norm_init = counted_obs_norm_init
    K1.launches = 0
    agent = train.run_job(cfg, job, device)
    torch.save(dict(launches=K1.launches, obs_norm=obs_norm, iteration=agent.iteration,
                    envs=agent.sampler_carry.obs.shape[0]),
               os.path.join(out_dir, f"rank{dist.rank()}.pt"))


def _dp_spawn(fn, args, share):
    """``dist.spawn`` of ``DP_RANKS`` ranks; ``share``: every rank on this
    process's first card (the children see that card alone)."""
    from mjrl_tpu_torch.parallel import dist

    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if share:
        os.environ["CUDA_VISIBLE_DEVICES"] = (visible or "0").split(",")[0]
    try:
        dist.spawn(fn, DP_RANKS, "cuda", args)
    finally:
        if visible is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = visible


def _dp_ant_check(tag, single, ranks):
    """Phase 15's checks of one two-rank ant run against one rank's."""
    import torch

    from mjrl_tpu_torch.parallel import dist

    parts = []
    for r, res in enumerate(ranks):
        start, stop = dist.row_block(NUM_ENVS, r, DP_RANKS)
        if res["launches"] != HORIZON or res["launches_2"] != HORIZON or \
                res["envs"] != stop - start:
            raise RuntimeError(f"{tag}: rank {r} launched K1 {res['launches']} and "
                               f"{res['launches_2']} times on {res['envs']} envs, expected "
                               f"{HORIZON} on {stop - start}")
        for f in DP_FIELDS:
            got, want = res["rows"][f], single["rows"][f][start:stop]
            if torch.equal(got, want):
                continue
            apart = (got != want).reshape(got.shape[0], got.shape[1], -1).any(-1).any(0)
            t = int(torch.nonzero(apart)[0])
            err = float((got[:, t].double() - want[:, t].double()).abs().max())
            parts.append(f"rank {r} {f} from step {t} ({err:.3g} there)")
            if err > DP_ROW_TOL:
                raise RuntimeError(f"{tag}: rank {r}'s {f} parts from one rank's at step {t} "
                                   f"by {err:.3g}, over {DP_ROW_TOL}")
    if not torch.equal(ranks[0]["flat"], ranks[1]["flat"]):
        raise RuntimeError(f"{tag}: the ranks' parameters differ")
    err = float((ranks[0]["flat"] - single["flat"]).abs().max())
    n1, n2 = single["metrics"]["num_samples"], ranks[0]["metrics"]["num_samples"]
    if err > DP_PARAM_TOL or n1 != n2 or ranks[0]["metrics"] != ranks[1]["metrics"]:
        raise RuntimeError(f"{tag}: parameters {err:.3g} from one rank's (tolerance "
                           f"{DP_PARAM_TOL}), num_samples {n2} against {n1}, the ranks' "
                           f"metrics alike: {ranks[0]['metrics'] == ranks[1]['metrics']}")
    print(f"[{tag}] {DP_RANKS} ranks ({ranks[0]['backend']}, {ranks[0]['device']} and "
          f"{ranks[1]['device']}): K1 {HORIZON} launches per iteration on each rank's "
          f"{ranks[0]['envs']} and {ranks[1]['envs']} envs; sampled rows "
          f"{'bit for bit' if not parts else 'parting: ' + '; '.join(parts)}; parameters the "
          f"same bits on both ranks, {err:.3g} from one rank's; num_samples {n2:.0f}; alpha "
          f"{ranks[0]['metrics']['alpha']:.6f} against {single['metrics']['alpha']:.6f}, kl "
          f"{ranks[0]['metrics']['kl_dist']:.6f} against {single['metrics']['kl_dist']:.6f}")
    print(f"[{tag}] iteration ms: 1 rank {single['ms']:.1f}, {DP_RANKS} ranks "
          f"{max(r['ms'] for r in ranks):.1f} (rank 0 {ranks[0]['ms']:.1f}, rank 1 "
          f"{ranks[1]['ms']:.1f})")
    return err


def phase_data_parallel(entry_rows):
    """Phase 15 (see the module's docstring); ``entry_rows``: phase 13's log
    rows by path. Returns each rank's K1 launches of the two paths."""
    import torch

    from mjrl_tpu_torch.envs import make
    from mjrl_tpu_torch.physics.pkernel import K1
    from mjrl_tpu_torch.train import load_config, run_job

    env = make("ant", horizon=HORIZON)
    single = _dp_iterations(env, _agent(env, horizon=HORIZON), K1)
    if single["launches"] != HORIZON:
        raise RuntimeError(f"dp ant: one rank launched K1 {single['launches']} times")
    with tempfile.TemporaryDirectory() as out:
        _dp_spawn(_dp_ant_rank, (out,), share=True)
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                 for r in range(DP_RANKS)]
    _dp_ant_check("dp ant", single, ranks)
    result = {"ant_dp": {"launches": [r["launches"] for r in ranks],
                         "ms_1_rank": single["ms"], "ms_2_ranks": max(r["ms"] for r in ranks)}}
    if torch.cuda.device_count() >= DP_RANKS:
        with tempfile.TemporaryDirectory() as out:
            _dp_spawn(_dp_ant_rank, (out,), share=False)
            nccl = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                    for r in range(DP_RANKS)]
        if nccl[0]["backend"] != "nccl":
            raise RuntimeError(f"dp ant: {torch.cuda.device_count()} cards, backend "
                               f"{nccl[0]['backend']}")
        _dp_ant_check("dp ant nccl", single, nccl)
    else:
        print(f"[dp ant] NCCL did not run: {torch.cuda.device_count()} card (it needs a card "
              f"per rank)")

    overrides = ["mesh_devices=2", "save_freq=1"]
    with tempfile.TemporaryDirectory() as job, tempfile.TemporaryDirectory() as out:
        cfg = load_config(ROOT / "examples" / "humanoid_ppo_v4.json", [*overrides, "niter=2"])
        _dp_spawn(_dp_entry_rank, (cfg, job, out), share=True)
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                 for r in range(DP_RANKS)]
        with open(os.path.join(job, "logs", "log.jsonl")) as f:
            lines = f.readlines()
        half = HUMANOID_PPO_ENVS // DP_RANKS
        want = dict(launches=3 * PPO_WINDOW, obs_norm=[PPO_WINDOW], iteration=2, envs=half)
        if any(r != want for r in ranks) or len(lines) != 2:
            raise RuntimeError(f"dp humanoid_ppo: ranks {ranks}, expected {want} each; log.jsonl "
                               f"{len(lines)} lines, expected 2")
        rows = [json.loads(line) for line in lines]
        agent = run_job(load_config(ROOT / "examples" / "humanoid_ppo_v4.json",
                                    [*overrides, "niter=3"]), job)
        with open(os.path.join(job, "logs", "log.csv"), newline="") as f:
            rows += [{k: float(v) for k, v in row.items()} for row in csv.DictReader(f)][2:]
        saved = sorted(os.listdir(os.path.join(job, "iterations")))
        on_card = all(t.is_cuda for t in [*agent.policy.parameters(), *agent.policy.buffers()])
        if agent.iteration != 3 or len(rows) != 3 or saved != ["1.pt", "2.pt", "3.pt"] or \
                not on_card or not all(math.isfinite(v) for row in rows for v in row.values()):
            raise RuntimeError(f"dp humanoid_ppo: resumed to iteration {agent.iteration}, rows "
                               f"{rows}, checkpoints {saved}, on the card {on_card}")
    for row in rows:
        print(f"[dp humanoid_ppo] iter {int(row['iteration'])}: {row['time_step'] * 1e3:.1f} ms "
              f"on {DP_RANKS} ranks, valid {row['steps_per_sec']:.1f} env-steps/s "
              f"({row['num_samples']:.0f} samples), score {row['stoc_pol_mean']:.3f}, alpha "
              f"{row['alpha']:.6f}, kl {row['kl_dist']:.5f}, log_std_mean "
              f"{row['log_std_mean']:.5f}, VF {row['VF_error_before']:.3f}->"
              f"{row['VF_error_after']:.3f}")
    one = entry_rows["humanoid_ppo"][-1]["time_step"] * 1e3
    print(f"[dp humanoid_ppo] each rank: {half} envs, K1 {PPO_WINDOW} launches per iteration and "
          f"{PPO_WINDOW} for obs_norm; the ranks' state held bit for bit at each checkpoint; "
          f"resumed to iteration 3 by run_job's own ranks; iteration ms: 1 rank "
          f"{one:.1f} (phase 13, its second iteration), {DP_RANKS} ranks "
          f"{rows[1]['time_step'] * 1e3:.1f} (the second iteration, rank 0's clock)")
    result["humanoid_ppo_dp"] = {"launches": [r["launches"] for r in ranks], "ms_1_rank": one,
                                 "ms_2_ranks": rows[1]["time_step"] * 1e3}
    return result


def phase_engine(every):
    """Phase 16 (see the module's docstring); ``every``: the kernels by
    name, the pose kernel (``POSES``) among them. Returns the line's
    results."""
    import numpy as np
    import torch

    from mjrl_tpu_torch.physics import engine, probe
    from mjrl_tpu_torch.physics.dispatch import make_frame_stepper
    from mjrl_tpu_torch.train import load_config
    from mjrl_tpu_torch.utils import evaluate_policy, export_rollout
    from mjrl_tpu_torch.utils.configs import build

    t_phase = time.perf_counter()
    kernels = list(every.values())
    result = {"vs_kernels": {}, "small_models": {}}

    def launched():
        return {k.name: k.launches for k in kernels if k.launches}

    # (i) against each kernel, from its own phase's states
    base = {"K1": TOL["K1"], "K2": TOL["K2"], "K3": TOL["K3 pen"], "K4": TOL["K4 pen"]}
    for row, _, _, kname in ENGINE_ROWS:
        kernel = every[kname]
        env = engine_row_env(row)
        model, frames = env.model, env.frame_skip
        q, qd, delta, ctrl = engine_row_states(row, env, ENGINE_ENVS)
        kw = {} if delta is None else {"link_delta": delta}
        kq, kqd = kernel(model, q, qd, ctrl, frames, **kw)
        for k in kernels:
            k.launches = 0
        eq, eqd = engine_control_step(model, frames, q, qd, ctrl, delta)
        torch.cuda.synchronize()
        if launched():
            raise RuntimeError(f"engine {row}: the engine launched {launched()}")
        spread = ENGINE_SPREAD_TOL[row]
        r = {"kernel": kname, "batch": ENGINE_ENVS}
        for name, got, want in (("q", eq, kq), ("qd", eqd, kqd)):
            if not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"engine {row}: {name} not finite")
            per_env = (got - want).abs().amax(dim=0)
            err, tol = float(per_env.max()), base[kname][name] + spread[name]
            r[f"{name}_max_abs_err"], r[f"{name}_tol"] = err, tol
            checks = [("max", err, tol)]
            if kname == "K4":
                quant = float(torch.quantile(per_env, HUMANOID_QUANTILE))
                qtol = TOL["K4 pen quantile"][name] + spread[f"{name}_quantile"]
                r[f"{name}_quantile_abs_err"], r[f"{name}_quantile_tol"] = quant, qtol
                checks.append((f"{HUMANOID_QUANTILE:.0%} quantile of the per-env", quant, qtol))
            for what, e, t in checks:
                ok = e <= t
                print(f"[engine vs {kname} {row}] B={ENGINE_ENVS} one control step {name}: {what} "
                      f"|err|={e:.3e} tol={t:.1e} ({kname}'s {base[kname][name]:.0e} + the "
                      f"engine's spread) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise RuntimeError(f"the engine disagrees with {kname} on {row}: {name}")
        r["ms"] = _cuda_ms(lambda: engine_control_step(model, frames, q, qd, ctrl, delta), 3)
        r["kernel_ms"] = _cuda_ms(lambda: kernel(model, q, qd, ctrl, frames, **kw), 3)
        print(f"[engine vs {kname} {row}] one control step at B={ENGINE_ENVS}: engine "
              f"{r['ms']:.3f} ms, {kname} {r['kernel_ms']:.3f} ms (CUDA events)")
        result["vs_kernels"][row] = r

    # (ii) models outside the kernels' set: the card against the CPU
    for build_model in (probe.ball_chain_model, probe.link_plane_model):
        model = build_model()
        step = make_frame_stepper(model, ENGINE_FRAMES)
        if step.path != "engine":
            raise RuntimeError(f"{build_model.__name__}: the frame stepper runs {step.path}")
        q, qd, ctrl = (torch.as_tensor(x, device="cuda")
                       for x in probe.engine_states(model, ENGINE_ENVS, np.random.default_rng(0)))
        quat_adr = [int(model.link_qadr[i]) + (3 if t == 0 else 0)
                    for i, t in enumerate(model.link_jnt_type) if t in (0, 1)]  # free, ball
        worst = {"q": 0.0, "qd": 0.0, "quat_norm": 0.0}
        for k in kernels:
            k.launches = 0
        for _ in range(ENGINE_SMALL_STEPS):
            cq, cqd = step(q, qd, ctrl)
            hq, hqd = step(q.cpu(), qd.cpu(), ctrl.cpu())
            for name, got, want in (("q", cq, hq), ("qd", cqd, hqd)):
                rtol, atol = ENGINE_SMALL_TOL[name]
                got = got.cpu()
                excess = float(((got - want).abs() - (atol + rtol * want.abs())).max())
                worst[name] = max(worst[name], float((got - want).abs().max()))
                if not (excess <= 0 and bool(torch.isfinite(got).all())):
                    raise RuntimeError(f"{build_model.__name__}: the card's {name} parts from the "
                                       f"CPU's by more than rtol {rtol} / atol {atol}")
            for a in quat_adr:
                norm = torch.linalg.vector_norm(cq[:, a : a + 4], dim=-1)
                worst["quat_norm"] = max(worst["quat_norm"], float((norm - 1).abs().max()))
            q, qd = cq, cqd
        if worst["quat_norm"] > QUAT_NORM_TOL or launched():
            raise RuntimeError(f"{build_model.__name__}: quaternion norms off 1 by "
                               f"{worst['quat_norm']:.2e}, kernels {launched()}")
        ms = _cuda_ms(lambda: step(q, qd, ctrl), 3)
        name = build_model.__name__[: -len("_model")]
        result["small_models"][name] = {**worst, "ms": ms, "nq": model.nq, "nv": model.nv}
        print(f"[engine {name}] nq {model.nq}, nv {model.nv}: {ENGINE_SMALL_STEPS} chained control "
              f"steps ({ENGINE_FRAMES} frames) at B={ENGINE_ENVS}, card vs CPU max |err| q "
              f"{worst['q']:.3e} qd {worst['qd']:.3e} (rtol/atol q {ENGINE_SMALL_TOL['q']}, qd "
              f"{ENGINE_SMALL_TOL['qd']}) ok; quaternion norms within {worst['quat_norm']:.1e} of "
              f"1; {ms:.3f} ms per control step")

    # (iii) path (a) through the entry point, and the guard: unset, K4
    tag, config, overrides = ENGINE_PATH
    calls = [0]
    step_fn = engine.step

    def counted_step(*args, **kwargs):
        calls[0] += 1
        return step_fn(*args, **kwargs)

    rows = {}
    engine.step = counted_step
    try:
        phase_entry(tag, config, None, kernels, DAPG_ENVS, PEN_HORIZON, (1, 2), overrides, rows)
    finally:
        engine.step = step_fn
    want = (1 + 2) * PEN_HORIZON * 5  # the demos' rollout and two iterations, 5 frames a step
    if calls[0] != want:
        raise RuntimeError(f"{tag}: {calls[0]} engine steps, expected {want}")
    guard = ('env_kwargs={"constraint_solver": "newton"}', *overrides[1:])
    k4 = phase_entry(f"{tag}_use_soa_unset", config, every["K4"],
                     [k for k in kernels if k not in (every["K4"], every["POSES"])], DAPG_ENVS,
                     PEN_HORIZON, (1,), guard, rows, poses=every["POSES"])
    print(f"[{tag}] {calls[0]} engine.step calls (the demos and 2 iterations x {PEN_HORIZON} "
          f"steps x 5 frames), 0 kernel launches (the pose kernel's included); with use_soa "
          f"unset K4 launched {k4} times in its iteration")
    result["path"] = {
        "launches": 0, "engine_steps": calls[0], "k4_launches_use_soa_unset": k4,
        "iteration_ms": [row["time_step"] * 1e3 for row in rows[tag]],
        "steps_per_sec": [row["steps_per_sec"] for row in rows[tag]],
        "k4_iteration_ms": rows[f"{tag}_use_soa_unset"][0]["time_step"] * 1e3}

    # (iv) evaluation and export on the engine path
    cfg = load_config(ROOT / "examples" / config, [*overrides, "demo_file=null",
                                                   "algorithm=\"npg\"", "agent_kwargs={}"])
    env, policy, _, _ = build(cfg)
    for k in kernels:
        k.launches = 0
    stats = evaluate_policy(env, policy, num_episodes=8, horizon=ENGINE_EVAL_HORIZON,
                            percentiles=(50,), generator=torch.Generator(device="cuda").manual_seed(0))
    with tempfile.TemporaryDirectory() as out:
        data = np.load(export_rollout(env, policy, os.path.join(out, "rollout.npz"),
                                      horizon=ENGINE_EVAL_HORIZON,
                                      generator=torch.Generator(device="cuda").manual_seed(0)))
        shapes = {k: data[k].shape for k in data.files}
        finite = all(np.isfinite(data[k]).all() for k in data.files)
    T = shapes["rewards"][0]
    want_shapes = {"observations": (T, env.spec.observation_dim),
                   "actions": (T, env.spec.action_dim), "rewards": (T,), "qpos": (T, env.model.nq)}
    if env._frame_step.path != "engine" or launched() or shapes != want_shapes or not finite \
            or sorted(stats) != ["max", "mean", "min", "p50", "std"] \
            or not all(math.isfinite(v) for v in stats.values()):
        raise RuntimeError(f"engine evaluation: path {env._frame_step.path}, kernels {launched()}, "
                           f"stats {stats}, rollout {shapes} finite {finite}")
    print(f"[engine evaluation] evaluate_policy over 8 eval-mode episodes of "
          f"{ENGINE_EVAL_HORIZON} steps: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stats.items())
          + f"; export_rollout: {shapes}, finite; 0 kernel launches")
    result["evaluation"] = {"stats": stats, "rollout": {k: list(v) for k, v in shapes.items()}}
    result["seconds"] = time.perf_counter() - t_phase
    print(f"[engine] phase 16 took {result['seconds']:.1f} s")
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from mjrl_tpu_torch.envs import make
    from mjrl_tpu_torch.physics.pkernel import K1, K2, K3, K4, POSES, SIZE_CLASSES

    t0 = time.perf_counter()
    builds = [(K1, 0), (K1, 1), (K2, 0), (K3, 2), (K4, 2), (POSES, 2)]
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda b: b[0].build(b[1]), builds))
    print(f"[1] built {K1.source} in size classes {SIZE_CLASSES[:2]}, {K2.source} in "
          f"{SIZE_CLASSES[0]}, {K3.source}, {K4.source} and {POSES.source} in {SIZE_CLASSES[2]} "
          f"in {time.perf_counter() - t0:.1f} s")

    env = make("ant", horizon=HORIZON)  # on the card by default
    newton_env = make("ant", horizon=HORIZON, constraint_solver="newton", n_substeps=1)
    hopper = make("hopper", horizon=HOPPER_HORIZON)
    walkers = [make(name, horizon=HORIZON) for name in ("walker2d", "half_cheetah")]
    if any(e.device.type != "cuda" for e in (env, newton_env, hopper, *walkers)):
        raise RuntimeError("envs must default to the card")
    ragged = (NUM_ENVS, NUM_ENVS - 24)  # the second not a multiple of the block
    k1 = phase_kernel_vs_plain("K1", env, K1, 6, ragged)
    k2 = phase_kernel_vs_plain("K2", newton_env, K2, 3, ragged, warm_steps=15, warm_scale=0.0)
    k1_hopper = phase_kernel_vs_plain("K1 hopper", hopper, K1, 6, (HOPPER_ENVS, HOPPER_ENVS - 6),
                                      fold=True)
    k1_walkers = {e.asset[:-4]: phase_kernel_vs_plain(f"K1 {e.asset[:-4]}", e, K1, 1, (NUM_ENVS,),
                                                      timed=False)
                  for e in walkers}
    walker_trpo = make("walker2d", horizon=HOPPER_HORIZON)
    k1_walker_trpo = phase_kernel_vs_plain("K1 walker2d_trpo", walker_trpo, K1, 6,
                                           (TRPO_ENVS, TRPO_ENVS - 6))
    k1["launches"] = phase_slice("penalty", env, _agent(env, horizon=HORIZON), K1, K2)
    newton_agent = _agent(newton_env, num_samples=NUM_ENVS * HORIZON, sample_mode="samples")
    k2["launches"] = phase_slice("newton", newton_env, newton_agent, K2, K1)

    hopper_newton = make("hopper", horizon=HOPPER_HORIZON, constraint_solver="newton")
    swimmer = make("swimmer", horizon=HOPPER_HORIZON)
    k2_hopper = phase_kernel_vs_plain("K2 hopper", hopper_newton, K2, 3,
                                      (HOPPER_ENVS, HOPPER_ENVS - 6), fold=True)
    k2_hopper["condims_max_abs_err"] = phase_k2_condims("K2 hopper", hopper_newton, K2,
                                                        HOPPER_ENVS - 6)
    k1_swimmer = phase_kernel_vs_plain("K1 swimmer", swimmer, K1, 6, (HOPPER_ENVS, HOPPER_ENVS - 6),
                                       tol=TOL["K1 swimmer"])
    humanoid = make("humanoid", horizon=HOPPER_HORIZON)
    k1_humanoid = {
        "humanoid_trpo": phase_kernel_vs_plain(
            "K1 humanoid", humanoid, K1, 3, (HUMANOID_TRPO_ENVS, HUMANOID_TRPO_ENVS - 6),
            fold=True, tol=TOL["K1 humanoid"], kinds=SPHERE_KINDS, quantile=HUMANOID_QUANTILE),
        "humanoid_ppo": phase_kernel_vs_plain(
            "K1 humanoid", humanoid, K1, 1, (HUMANOID_PPO_ENVS,), fold=True,
            tol=TOL["K1 humanoid"], kinds=SPHERE_KINDS, quantile=HUMANOID_QUANTILE),
    }
    pen = make("adroit_pen", horizon=PEN_HORIZON)
    k3 = phase_k3("K3 pen", pen.model, pen.frame_skip, K3, adroit_states(pen, PEN_ENVS, 3),
                  (PEN_ENVS, PEN_ENVS - 6), TOL["K3 pen"])
    k3_tasks = {}
    for task in ("hammer", "door", "relocate"):
        env = make(f"adroit_{task}")
        if env.device.type != "cuda":
            raise RuntimeError("envs must default to the card")
        k3_tasks[task] = phase_k3(f"K3 {task}", env.model, env.frame_skip, K3,
                                  adroit_states(env, PEN_ENVS, 1), (PEN_ENVS,), TOL[f"K3 {task}"],
                                  wide=ADROIT_WIDE if task != "door" else None)
    pen_newton = make("adroit_pen", horizon=PEN_HORIZON, constraint_solver="newton")
    # the launch with 3 warps per block at B=512 is ragged (170 full blocks
    # and one of 2), so the run at B=506 is left out for the time
    k4 = phase_k4("K4 pen", pen_newton, K4, 3, (PEN_ENVS,), TOL["K4 pen"],
                  TOL["K4 pen quantile"], train_states=True)
    k4_tasks = {}
    for task in ("door", "hammer", "relocate"):
        env = make(f"adroit_{task}", constraint_solver="newton")
        k4_tasks[task] = phase_k4(f"K4 {task}", env, K4, 1, (K4_TASK_ENVS,), TOL["K4 pen"],
                                  TOL["K4 pen quantile"], wide=2 * K4_TASK_ENVS, bound=False,
                                  plain_on_cpu=True, replay=True)
    poses = phase_poses(POSES, PEN_ENVS)
    every = {"K1": K1, "K2": K2, "K3": K3, "K4": K4}
    entry_rows, entry, pose_launches = {}, {}, {}
    for tag, config, k, n, steps, niters, overrides in ENTRY_PATHS:
        # the pose kernel on the paths whose env runs it; elsewhere none
        on_poses = tag.startswith("adroit_") and tag.split("_")[1] in POSE_TASKS
        others = [v for name, v in every.items() if name != k] + ([] if on_poses else [POSES])
        entry[tag] = phase_entry(tag, config, every.get(k), others, n, steps, niters, overrides,
                                 entry_rows, poses=POSES if on_poses else None)
        if on_poses:
            pose_launches[tag] = steps + 1
    phase_breadth([*every.values(), POSES])
    data_parallel = phase_data_parallel(entry_rows)
    engine_result = phase_engine({**every, "POSES": POSES})
    k1_hopper["launches"] = entry["hopper"]
    k3["launches"] = entry["adroit_pen"]
    k4["launches"] = entry["adroit_pen_newton"]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kernels = []
    for kernel, r in ((K1, k1), (K2, k2), (K3, k3), (K4, k4)):
        kernels.append({
            "name": kernel.name, "route": "cuda", "source": kernel.source,
            "replaces": kernel.replaces, "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
    kernels[0]["warps_per_block"] = k1["warps_per_block"]
    kernels[1].update(warps_per_block=k2["warps_per_block"], overflow=k2["overflow"])
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "launches", "max_abs_err", "warps_per_block")
    kernels[0]["hopper"] = {k: k1_hopper[k] for k in keys}
    for name, r in k1_walkers.items():
        kernels[0][name] = {"max_abs_err": r["max_abs_err"],
                            "warps_per_block": r["warps_per_block"]}
    kernels[0]["swimmer"] = {k: k1_swimmer[k] for k in keys if k != "launches"}
    kernels[0]["swimmer"]["launches"] = entry["swimmer"]
    kernels[0]["walker2d_trpo"] = {k: k1_walker_trpo[k] for k in keys if k != "launches"}
    kernels[0]["walker2d_trpo"]["launches"] = entry["walker2d_trpo"]
    for name, r in k1_humanoid.items():
        kernels[0][name] = {k: r[k] for k in keys if k != "launches"}
        kernels[0][name].update(launches=entry[name], kind_env_steps=r["kind_env_steps"])
    kernels[1]["line_search_flips"] = k2["line_search_flips"]
    kernels[1]["hopper"] = {k: k2_hopper[k] for k in keys if k != "launches"}
    kernels[1]["hopper"].update(launches=entry["hopper_newton"],
                                line_search_flips=k2_hopper["line_search_flips"],
                                link_pair_env_steps=k2_hopper["link_pair_env_steps"],
                                overflow=k2_hopper["overflow"],
                                condims_max_abs_err=k2_hopper["condims_max_abs_err"])
    kernels[2].update(kind_env_steps=k3["kind_env_steps"], warps_per_block=k3["warps_per_block"])
    for task, r in k3_tasks.items():
        kernels[2][task] = {k: r[k] for k in keys if k != "launches"}
        kernels[2][task].update(launches=entry[f"adroit_{task}"], kind_env_steps=r["kind_env_steps"])
        if "wide" in r:
            kernels[2][task]["wide"] = r["wide"]
    # the DAPG paths run K1's and K3's checked builds; their launches
    kernels[0]["hopper_dapg"] = {"launches": entry["hopper_dapg"]}
    kernels[0]["hopper_model_npg"] = {"launches": entry["hopper_model_npg"]}
    kernels[0].update(data_parallel)
    for task in ("pen", "door", "hammer", "relocate"):
        kernels[2][f"{task}_dapg"] = {"launches": entry[f"adroit_{task}_dapg"]}
    kernels[3].update({k: k4[k] for k in ("quantile", "quantile_abs_err", "env_steps",
                                          "held_rows_mean", "held_rows_max",
                                          "line_search_flips", "overflow", "train_states",
                                          "warps_per_block")})
    for task, r in k4_tasks.items():
        kernels[3][task] = {k: r[k] for k in (*keys, "quantile", "quantile_abs_err", "env_steps",
                                              "held_rows_mean", "held_rows_max",
                                              "line_search_flips", "overflow", "wide") if k in r}
        kernels[3][task]["launches"] = entry[f"adroit_{task}_newton"]
    keys = ("ms", "stream_ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "pos_max_abs_err",
            "quat_max_abs_err", "sites_max_abs_err", "q_strides")
    kernels.append({"name": POSES.name, "route": "cuda", "source": POSES.source,
                    "replaces": POSES.replaces, **{k: poses["pen"][k] for k in keys},
                    "library_ms": None, "launches_per_iteration": pose_launches})
    for task in POSE_TASKS[1:]:
        kernels[4][task] = {k: poses[task][k] for k in keys}
    print(json.dumps({"engine": engine_result}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
