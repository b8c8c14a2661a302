#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

The main path is the registry autotuning loop, ``autotuned(name)(*args)``:
shape class → TuningDB lookup → candidate space emitted from the card's
ArchSpec → staged search (hint prescreen, then finals timed on the card)
→ ``record_best`` → zero-evaluation recall and the dispatch fast path.  It
runs for all five ported kernels at real sizes:

* ``exb`` at the paper's GKV domain (iv, iz, mx, my) = (16, 16, 128, 65), f32
  (tunables block_iv, block_iz and split);
* ``flash_attention`` at tinyllama-1.1b's attention width (32 query heads,
  4 KV heads, head_dim 64), B=1, S=2048, bf16 (the wgmma kernel), then in
  f32 (the 3xTF32 mma.sync kernel, its own shape class), then bf16 again
  at B=4 (B·H = 128, its own shape class);
* ``stress`` on one card's Seism3D subdomain (nk, nj, ni) = (256, 256, 256), f32;
* ``ssm_scan`` at falcon-mamba-7b width (d_inner 8192, ssm_state 16), B=1,
  S=2048, f32, then bf16 (its own shape class), then f32 at B=4, S=2047;
* ``rglru_scan`` at recurrentgemma-2b width (lru_width 2560), B=1, S=2048,
  f32, then bf16 (its own shape class), then f32 at B=4, S=2047;
* flash again at recurrentgemma-2b's head dim 256 (10 query heads, 1 KV
  head), bf16 (its own shape class);
* the paper's apps on the loop-nest kernel: the GKV region (10 loop
  variants × 9 degrees at (16, 16, 128, 65)) tuned through the Tuner and
  recalled from its TuningDB, the Seism3D region at 256³ likewise, and the
  Fig. 12 degree switch on it;
* the model zoo's serving entry points (``repro_torch.models``: prefill,
  then greedy decode) on random bf16 weights from the seed, at full width:
  tinyllama-1.1b at full depth (22 layers, flash at hd 64), falcon-mamba-7b
  at 2 layers (``ssm_scan`` with its final state) and recurrentgemma-2b at
  3 layers (``rglru_scan``, flash at hd 256), B=1, a 2048-token prompt,
  sharing the kernel phases' TuningDB; and every arch at its SMOKE config;
* the serving slice (``repro_torch.runtime``) on the same models: the
  static ``Server`` and the continuous-batching ``StreamingEngine``, each
  run with its own TuningDB and ``BackgroundTuner``;
* the training slice (``repro_torch.runtime.Trainer``), run first while
  the card's memory is empty: tinyllama-1.1b uncut, bf16, B=4, S=4096,
  causal attention forward and backward on the flash kernels; then the
  scans' families on their backward kernels (``ssm_scan_bwd``,
  ``rglru_scan_bwd``): recurrentgemma-2b uncut (B=1, S=2048; flash at hd
  256 forward and backward) and falcon-mamba-7b at full width, 8 of 64
  layers (B=2, S=2048).

Phases, each of which fails the run:

1. the card: name and power limit as ``nvidia-smi`` prints them;
2. build: every CUDA source compiled with nvcc, all at once (build time,
   registers and spills; every flash instantiation, forward and
   backward, bf16 and f32, and every scan instantiation must not spill);
2a. training (``[train]`` lines), each run with the counts set to 0 just
   before it and read just after: tinyllama-1.1b's gradient at full width,
   2 of 22 layers, B=1, S=2048, wq and wk tempered, on the kernel route
   against the plain versions under remat full and dots (worst leaf
   ‖g−r‖/‖r‖ ≤ 1e-3 in float32 params, 3e-2 in bf16, exact launches);
   uncut at B=4, S=4096: ``Trainer.joint_tune`` over micro (1, 2, 4) ×
   remat (none, full), each measured step read through its ``trial`` hook
   (time, peak memory, exact flash launches), 20 steps at the winner
   (step ms beside ``analytic_step_flops`` at the bf16 peak, MFU,
   tokens/s, launches exactly 22 forward (44 with full) and 22 backward a
   step × n_micro, 0 plain calls, each kernel class's evaluations), a
   second Trainer on the same DB recalling the winner and every kernel
   class with 0 evaluations, whose step then overfits one batch from
   tempered weights (the loss must fall), and one more step profiled
   (``torch.profiler``: device ms of flash forward, flash backward, GEMMs
   and the rest); a restart drill (2
   layers, B=2, S=1024, 8 steps, a failure before step 5: losses
   bit-identical to an uninterrupted run's); one step of each trainable
   SMOKE family card vs CPU in float32 (each leaf's update within 2e-2 of
   the CPU's in norm; in Whisper, whose gradients all run through its bf16
   encoder, 0.25, and the encoder's bf16 leaves' worst row 4·2⁻⁸), the SSM and
   hybrid families among them on the scans' backward kernels; the same
   gradient check on falcon-mamba-7b (2 of 64 layers) and recurrentgemma-2b
   (3 of 26) at full width, B=1, S=2048, every kernel's forward and
   backward launches exact; recurrentgemma-2b uncut (B=1, S=2048) and
   falcon-mamba-7b at full width and 8 of 64 layers (B=2, S=2048) through
   the ``Trainer`` at remat none, bf16 parameters: a warm step that tunes
   the kernel classes inline, then 10 steps (step ms beside
   ``analytic_step_flops`` at the bf16 peak, MFU, tokens/s, peak memory;
   launches exactly rglru_scan 18 forward and 18 backward and flash 8 and
   8 a step, or ssm_scan 8 and 8; 0 plain calls), a second Trainer
   recalling every kernel class with 0 evaluations, the step overfitting
   one batch from tempered weights (the loss must fall) and one profiled
   step; the restart drill again on recurrentgemma-2b at 3 layers;
2b. the dry-run (``[dryrun]`` lines): ``repro_torch.launch.dryrun.run_cell``
   on a (1, 1) mesh for tinyllama-1.1b uncut at the [train] cell (B=4,
   S=4096, bf16 parameters, float32 moments), one row a (micro, remat)
   that phase measured, in a worker that sees no card (started with the
   run; a forked worker a row, all at once): the predicted per-device peak
   beside the measured peak
   and their ratio, which must lie in 0.75-1.25; the phase allocates
   nothing on the card and takes under 30 s;
3. kernels: every point of each emitted space launched at the slice shapes
   (flash also in f32, at a padded S=2000, and in bf16 at qwen3-0.6b's
   width, 16 query heads, 8 KV heads, head_dim 128; both scans also in
   bf16, their f32 inputs cast, and in f32 at B=4, S=2047, whose last trip
   is short) and held against the plain PyTorch version on the card within
   the stated tolerance; the scans also at S=1 and S=7 on narrow widths,
   every emitted point and a few more (a CTA of less than a warp, bf16 rows
   of an odd length), in f32 and bf16;
3a. flash head dims: every emitted point in both dtypes at hd 80
   (microsoft/phi-2's shape: 32|32 heads), hd 64 at the same heads (what
   the hd-128 tile costs hd 80) and hd 256 (recurrentgemma-2b: 10|1
   heads), S=2048; one non-causal call a dtype at hd 64;
3b. ``ssm_scan`` state sizes: every emitted point at N = 12 and 64 (D=8192,
   S=2048) in f32 and bf16, and at N = 256 on a narrow width;
3c. the apps: every (variant, degree) of GKV (10 × 9) and of Seism3D at
   64³ and 256³ (6 × 9 each) against the plain body on the card, each call
   timed once;
3e. the flash backward: at tinyllama width (32|4, hd 64), S=4096 at B=1
   and at the train step's B=4, and S=2000, qwen3-0.6b's (16|8, hd 128) and
   hd 36 (8|2), bf16 and f32, the forward with its lse (o equal to the call
   without it, lse against the plain version's), then every emitted point
   of ``flash_attention_bwd`` (``kv_split`` included; at recurrentgemma-2b's
   (10|1, hd 256) too, bf16 and f32, tuned through the registry beside its
   fastest swept point and SDPA's backward, bf16's passes timed) against
   ``attention_bwd_plain`` in float32 (bf16) or float64 (f32), the plain
   versions a batch row at a time, per element at ``DEFAULT_TOL`` and worst
   row (dq without query 0), and called twice for the same bits; the
   tinyllama class of each dtype, and bf16's at B=4, tuned and recalled
   with 0 evaluations, its time beside the bound (five causal products),
   the plain version's and SDPA's backward, and in bf16 each pass's time
   (``[kernel] flash bwd passes``);
3f. the scans' backward kernels: every emitted point of ``ssm_scan_bwd``
   at falcon-mamba-7b's width (B=1 f32 and bf16, B=2, S=2047), N = 12 and
   64 on a narrow width and S = 1, 7, and of ``rglru_scan_bwd`` at
   recurrentgemma-2b's (B=1 f32 and bf16, B=2, S=2047) and S = 1, 7, against
   the plain backward on the same inputs in float64 (f32) or float32 (bf16):
   the per-position gradients per element at the scans' tolerance, the
   summed ones (dA, dB_t, dC_t, dD; dλ) to a worst row of 1e-4, bf16 at
   the bf16 tolerances; every point called twice for the same bits, its
   shared memory, scratch and launch bound against the source's, the
   fastest point beside the bound (bytes, and ``ssm_scan``'s exps on the
   SFU) and the forward's time at the same shape, and each phase's time at
   the fastest point of falcon's train cell and of recurrentgemma's
   (1,2048,2560) f32 (``[kernel] ssm_scan|rglru_scan bwd phases``);
   ``[ptxas]`` lines for every instantiation (0 B spilled);
3d. head dims off the kernels' 16-byte rule (C3): every emitted flash point
   at hd 12, 36, 100 (bf16) and 6, 50 (f32), S=2048, 8|2 heads, run padded
   by the wrapper, against the plain version, and the copy's cost (the
   wrapper's time against the kernel alone on inputs padded beforehand);
   ``ssm_scan`` with its final state at every emitted point of the falcon
   shape class, y and h against the plain version's;
4. main path, per kernel: every launch count reset, a cold tune
   (evaluations > 0), a fresh op on the same DB file recalling with 0
   evaluations and two fast-path calls; the counts read at once: the
   kernel launched, and no plain version ran; for exb one exhaustive
   search compared with the staged winner, for the others the staged
   winner's time beside the fastest swept point's (flash f32's within 10%
   of it, or the run fails); flash once more in f32 and at B=4, and each
   scan once more in bf16 and in f32 at B=4, S=2047, each of which must
   tune a shape class of its own and recall it (at B=4, S=2047 the staged
   winner's time is set beside the fastest swept point's: a check of the
   hint away from the shape its constants were fitted at); flash at hd 256
   in bf16 tuned and recalled; then the apps: the GKV and Seism3D regions
   tuned cold through the Tuner (the GKV one as Figs. 13–14), recalled
   from a fresh TuningDB with no measurement, the recalled point run and
   checked, and Fig. 12 (a DegreeController switch a call) at 256³; the
   ``[fig11]``..``[fig14]`` lines set each figure beside the paper's;
5. the models (``[model]`` lines), each phase with the counts reset before
   its prefill and read after it: the evaluations each shape class spent
   tuning (0 for every class a kernel phase tuned: the model path recalls
   them), the launches of a prefill (one flash call a causal attention
   layer, one scan a recurrent layer; no plain call), prefill ms and
   decode ms a token (CUDA events) beside their bounds
   (``analytic_step_flops`` at the bf16 peak; the bytes a decode step must
   move at the memory rate), the hand-written kernels' share of one
   ``torch.profiler`` prefill, each kernel call of a prefill against its
   plain version on the same inputs (flash: worst row within 4·2⁻⁸; the
   scans: their f32 tolerance), and, on the same weights with the
   attention projections drawn at the fan-in of d_model (``temper``: the
   JAX init's fan-in of the heads makes a full-width model chaotic, one
   bf16 ulp flipping a softmax), the kernel route's last logits against
   the plain versions' on the card (worst row within 4·2⁻⁸) and decode
   after prefill (prompt[:512] and one step against prefill of
   prompt[:513], within ``tests/test_models.py``'s rtol 0.1, atol 0.08),
   both also reported, unchecked, at the JAX init; then every arch at
   SMOKE, tempered: prefill and 4 decode steps on the card against the
   port's CPU run on the same weights (worst row within 4·2⁻⁸);
6. serving (``[serve]`` lines), bf16 tempered weights, each run with the
   counts set to 0 just before it and read just after (the serving
   thread's launches apart from its background tuner's trials), its own
   TuningDB and ``BackgroundTuner``: tinyllama-1.1b uncut through the
   ``Server`` (batch 4, ``mixed_traffic_trace(cfg, 8, seed=0)``; the tuner
   must drain within 60 s), then the same trace on the same DB (0
   evaluations of any kind, every class recalled) and ``joint_tune`` twice
   (the second recalls with 0), then the ``StreamingEngine`` (8 blocks,
   ``bursty_open_loop_trace(cfg, 16, seed=0, burst_size=4,
   burst_gap_s=0.05)``), whose tuner then drains its kernel and degree
   classes for up to 60 s (the scheduler's are dropped first), the same
   trace with no tuner (the control), and again on the drained DB with no
   tuner (0 evaluations; every class that landed is recalled, flash's and
   a degree class's among them); falcon-mamba-7b (2 layers) and
   recurrentgemma-2b (3 layers) at full width through the engine on 8
   requests; every arch at SMOKE through the engine on the card against
   the port's engine on the CPU; tinyllama's SMOKE config on
   ``adversarial_trace`` under a seeded ``ChaosInjector`` with a
   ``TickTimer``.  Each run prints its requests, tokens and tok/s, TTFT
   p50/p99 (engine), prefill ms a group and decode ms a step beside the
   step's byte bound at its rows, traffic classes, hot-path evaluations
   (must be 0), what the tuner landed, the serving thread's kernel
   launches (each expected kernel launched, once for every call of its
   route) and plain calls (0, on any thread), each prefill kernel call of
   the serving thread against its plain version, the drain contract
   (engine), and each request's tokens against the one-at-a-time oracle
   (``Server(batch_size=1)``; for the static Server each prompt padded to
   its group's length, as the Server feeds it): equal, or parted at a
   near-tie, where both runs' own logits of the two tokens (recorded at
   each greedy pick) lie within 2 bf16 ulps (bf16-rounded logits tie, and
   a batch of rows rounds a product differently from one row); any other
   parting, near-ties in more than half a run's requests or an eighth of
   all compared, fail the run.  The runtime sets bf16 GEMMs to accumulate
   without reduced-precision split-K steps (``full_precision_reductions``);
7. the fleet slice (``repro_torch.fleet``), after the serving phases:
   ``[fleet]`` flash bf16 at tinyllama-1.1b's width (1,2048,32|4,64) and
   ``exb`` at the GKV domain, each searched by a ``FleetCoordinator`` of 1
   and of 2 thread workers (stride shards) with the registry's measured
   cost (each point measured once, the winner the merged argmin recorded
   final, a fresh op recalling it with 0 evaluations, the 2-worker winner
   re-timed within 10% of the 1-worker one, both wall times printed); then
   ``launch.fleet --kernel <k> --workers 2`` for the five kernels and
   ``--kernel demo --backend spawn --check-equivalence``, each exit 0;
   ``[service]``: a ``TuningService`` over HTTP on 127.0.0.1, two hosts
   measuring their halves of exb's space through seeded lossy transports
   (host 1's final the union's argmin), a third, device-keyed host's
   ``BackgroundTuner`` recalling it with 0 evaluations, another platform's
   pull answered ``nearest`` (a warm-start seed, no final), and
   ``launch.observe metrics --url`` on the service; ``[drift]``: a kernel
   whose candidate ``i`` launches exb ``reps[i]`` = 1, 1, 3 times, tuned and
   called 64 times with every call monitored (0 transitions, and 0
   switches of the straggler selector beside the watch), then its
   winner slowed to 4 launches (demoted, re-tuned with every point measured
   again, canaried, the other one-launch candidate promoted); the serve CLI at tinyllama-1.1b's full width (the
   static Server on a mixed trace of 64 with ``--background-tune
   --fleet-workers 2 --drift-factor 2 --device-key``, then of 128 on its
   DB: each run 0 hot-path evaluations, 0 transitions over a non-zero
   number of observations held against a final, printed by class) and the
   CI obs-smoke job's streaming run
   (``[observe]``: ``launch.observe trace``, ``metrics`` and ``explain`` on
   its files exit 0, ``explain`` naming ``engine_prefill``,
   ``engine_decode`` and ``serve_scheduler``); ``[example]``:
   ``examples/torch_train_lm.py --device cuda`` at its defaults, a loss drop
   of at least 20%, its steps a second printed.

The line before the last is ``{"kernels": [...]}``: per kernel its launches
on the main path, max error over the sweep, time at the tuned point, the
plain version's time, the bound (bytes over memory rate or operations over
peak rate, the larger) and the library call's time; flash's also gives
the f32 kernel's (``f32_*``: 3xTF32 operations over the TF32 rate, SDPA's
memory-efficient kernel in f32 as the library call); the scans' entries
also give their bf16 time, bound and tuned point, their B=4, S=2047
tuned point and time beside the fastest swept one (``b4_s2047_*``), and
``ssm_scan`` its SFU floor (one exp per (t, d, n) at 16 a clock per SM);
flash's and ``ssm_scan``'s also give their times at the new head dims and
state sizes beside their bounds; ``loop_nest_gkv`` and
``loop_nest_seism3d`` give the tuned point's time, its outer launches and
CTAs, and the bound of the domain's bytes; the kernels on the model path
also give ``model_launches`` (a prefill's, per model),
``serve_launches`` (per serve run, the serving thread's) and
``serve_trial_launches`` (its background tuner's trials), flash and exb
``fleet_launches`` (the ``[fleet]`` searches', per worker count), exb
``service_launches`` (per host) and ``drift_launches``, flash its
``c3`` rows and ``ssm_scan`` its final state's errors; flash also its
``lse_ms`` and ``train_launches``, and ``flash_attention_bwd`` its time,
bound, plain and SDPA-backward times (``library_ms``, ``sdpa_bwd_ms``) in
bf16, at B=4 (``b4_*``, with ``passes_ms`` as at B=1) and in f32
(``f32_*``) and at hd 256 (``hd256_*``, ``f32_hd256_*``), and
``train_launches`` (flash's forward also SDPA's forward time at hd 256,
``hd256_library_ms``); ``ssm_scan_bwd`` and ``rglru_scan_bwd`` their
launches in the falcon-mamba-7b and recurrentgemma-2b ``[train]`` runs,
the time of the point the Trainer tuned at that run's shape in float32, the
bound, the plain backward's time, the forward's time beside it and every
swept shape's fastest point.  A ``{"models": ...}``,
a ``{"serve": ...}``, a ``{"fleet": ...}`` and a ``{"train": ...}`` line
before it hold the model, serve, fleet and train phases' records.  The last line is
``{"ok": true, "device": {...}}``.  The script exits non-zero, and prints
no result, without a CUDA card or without the repository beside it.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# (rtol, atol) per dtype: the JAX package's DEFAULT_TOL (tests/conformance.py)
TOL = {"float32": (2e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}
# the scans' conformance tolerance (tests/conformance.py, ssm_scan/rglru_scan)
SCAN_TOL = (1e-4, 1e-4)
# Per output row (the last axis: one head's hd values, one my line of exb,
# one ni line of stress, one time step's channels of a scan): error norm
# over the plain version's norm, worst row.  The element check alone is
# loose for bf16 attention at S=2048, whose outputs are only
# 0.03-0.05, so a kernel that dropped one 64-key block would stay inside
# atol 2e-2.  bf16: four ulps of the output (4 * 2**-8); f32: the rtol.
ROW_TOL = {"float32": 2e-4, "bfloat16": 4 * 2.0**-8}

EXB_DIMS = (16, 16, 128, 65)
# tinyllama-1.1b: 32 query heads, 4 KV heads, head_dim 64
FLASH = dict(B=1, S=2048, H=32, KV=4, hd=64)
# qwen3-0.6b: 16 query heads, 8 KV heads, head_dim 128 (two TMA boxes a row)
FLASH_HD128 = dict(B=1, S=2048, H=16, KV=8, hd=128)
FLASH_B = 4  # the B·H phase: B·H = 128
# head dims the kernels run on a larger tile: microsoft/phi-2 (32|32 heads,
# head_dim 80; its shape only), and recurrentgemma-2b (10|1 heads, 256)
FLASH_HD80 = dict(B=1, S=2048, H=32, KV=32, hd=80)
FLASH_HD256 = dict(B=1, S=2048, H=10, KV=1, hd=256)
# one card's subdomain of the Seism3D FDM grid: 23 fields of 64 MiB, 30x the L2
STRESS_DIMS = (256, 256, 256)
# falcon-mamba-7b (d_inner, ssm_state) and recurrentgemma-2b (lru_width)
SSM = dict(B=1, S=2048, D=8192, N=16)
RGLRU = dict(B=1, S=2048, W=2560)
# state sizes that are no power of two or past 32, at falcon-mamba-7b width
SSM_STATES = (12, 64)
SSM_N256 = dict(B=1, S=64, D=64, N=256)
# the scans' second shape: a batch, and a length that no chunk divides
ODD = dict(B=4, S=2047)
# narrow shapes at S = 1 (decode) and 7, with points the emitted spaces
# leave out: a CTA of 16 threads, 6-byte bf16 rows, a chunk past S
SSM_SHORT = [(dict(B=2, S=7, D=64, N=16), [dict(block_d=2, chunk=7, states=1)]),
             (dict(B=1, S=1, D=64, N=16), []),
             (dict(B=1, S=40, D=64, N=4), [dict(block_d=8, chunk=32, states=1)])]
RGLRU_SHORT = [(dict(B=2, S=7, W=24), [dict(block_w=8, chunk=7, split=2),
                                       dict(block_w=3, chunk=7, split=1)]),
               (dict(B=1, S=1, W=24), [dict(block_w=3, chunk=1, split=1)]),
               (dict(B=1, S=64, W=128), [dict(block_w=8, chunk=24, split=2)])]


# the scans' backward kernels, every emitted point of each (shape, dtype):
# falcon-mamba-7b's width at B=1 (f32, bf16), at the train step's B=2 and at
# S=2047 (a short last chunk); N=12 and 64 on a narrow width; S=1 and 7;
# recurrentgemma-2b's width likewise
SSM_BWD_SHAPES = ((SSM, ("float32", "bfloat16")), (dict(SSM, B=2), ("float32",)),
                  (dict(SSM, S=2047), ("float32",)),
                  (dict(B=2, S=300, D=256, N=12), ("float32", "bfloat16")),
                  (dict(B=2, S=300, D=256, N=64), ("float32", "bfloat16")),
                  (dict(B=2, S=7, D=64, N=16), ("float32", "bfloat16")),
                  (dict(B=1, S=1, D=64, N=16), ("float32", "bfloat16")))
RGLRU_BWD_SHAPES = ((RGLRU, ("float32", "bfloat16")), (dict(RGLRU, B=2), ("float32",)),
                    (dict(RGLRU, S=2047), ("float32",)),
                    (dict(B=2, S=7, W=24), ("float32", "bfloat16")),
                    (dict(B=1, S=1, W=24), ("float32", "bfloat16")))
# the backward's gradients that add up many float32 terms in another order
# than the plain version's (ssm_scan's dA and dD over B·S, dB_t and dC_t
# over the D channels; rglru_scan's dlam over B·S): in float32 each is held
# to a worst row of SUM_ROW_TOL (the CPU tests hold the plain versions' sums
# to a relative norm of 1e-4), the per-position gradients to SCAN_TOL per
# element; bf16 all to the bf16 tolerances
SCAN_BWD_SUMMED = {"ssm_scan": (2, 3, 4, 5), "rglru_scan": (3,)}
SUM_ROW_TOL = 1e-4

# the model zoo on the card: (arch, depth or None for the full depth,
# decode steps) at full width, B=1, a 2048-token prompt
MODELS = (("tinyllama-1.1b", None, 32), ("falcon-mamba-7b", 2, 16),
          ("recurrentgemma-2b", 3, 16))
MODEL_S = 2048
MODEL_CHECK_S = 512  # decode after prefill: prompt[:512] + one step vs prompt[:513]
SMOKE_STEPS = 4      # decode steps of each SMOKE config, card against CPU
# C3: head dims off the kernels' 16-byte rule, run padded (S=2048, 8|2 heads)
C3_HEAD_DIMS = (("bfloat16", (12, 36, 100)), ("float32", (6, 50)))
C3_SHAPE = dict(B=1, S=2048, H=8, KV=2)
# the kernels each model phase reaches, by the name of their compiled entry
KERNEL_ENTRIES = {"flash_attention": ("flash_fwd",), "ssm_scan": ("ssm_kernel",),
                  "rglru_scan": ("rglru_kernel",)}
# the serving slice: tinyllama-1.1b uncut through the Server (batch 4) and
# the StreamingEngine (8 blocks); falcon-mamba-7b and recurrentgemma-2b at
# full width, 2 of 64 and 3 of 26 layers, through the engine
SERVE_BATCH = 4
SERVE_BLOCKS = 8
SERVE_ENGINES = (("falcon-mamba-7b", 2), ("recurrentgemma-2b", 3))
SERVE_DRAIN_S = 60.0  # the Server's background tuner must drain within this
# a request may part from its oracle only where both runs' own logits of the
# two tokens lie within 2 bf16 ulps; at most half of a run's requests, and
# an eighth of all compared, may part so
NEAR_TIE_ULPS = 2
NEAR_TIE_RUN_SHARE = 0.5
NEAR_TIE_SHARE = 0.125
SERVE_CHAOS = dict(step_fault_rate=0.2, squeeze_rate=0.2, squeeze_hold=3, delay_rate=0.2,
                   delay_s=0.01)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Device time of one call, as the tuner takes it (L2 flushed and the
    stream spun before each run, CUDA events around the call), median over
    ``reps`` runs, in ms."""

    def __init__(self, torch, device, l2_bytes: int):
        from repro_torch.core.cost import l2_flush

        self.torch = torch
        self.flush = l2_flush(device, 2 * l2_bytes)

    def ms(self, fn, reps: int = 10) -> float:
        from repro_torch.core.cost import _timed

        fn()
        self.torch.cuda.synchronize()
        times = sorted(_timed(fn, self.flush) for _ in range(reps))
        return times[len(times) // 2] * 1e3


def ptxas_entries(log: str) -> dict:
    """{kernel entry: (registers, spill store + load bytes)} from a
    ``-Xptxas -v`` log."""
    entries, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            entries[name] = (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            entries[name] = (entries[name][0], int(m.group(1)) + int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            entries[name] = (int(m.group(1)), entries[name][1])
    return entries


def outputs(out) -> tuple:
    """A kernel's result as a tuple of tensors (a dict in its key order)."""
    if isinstance(out, dict):
        return tuple(out.values())
    return out if isinstance(out, tuple) else (out,)


def as_real(torch, t):
    """A tensor in float32; a complex one as its (re, im) pairs along the
    last axis, so a row is one line of both parts."""
    if t.is_complex():
        return torch.view_as_real(t).flatten(-2)
    return t.float()


def max_err(torch, out, ref, dtype: str, tol=None):
    """(max abs error, worst row error ratio, list of the checks failed)."""
    rtol, atol = tol or TOL[dtype]
    worst, worst_row, failed = 0.0, 0.0, []
    for o, r in zip(out, ref):
        o, r = as_real(torch, o), as_real(torch, r)
        if o.shape != r.shape or not bool(torch.isfinite(o).all()):
            return math.inf, math.inf, ["shape/finite"]
        diff = (o - r).abs()
        worst = max(worst, float(diff.max()))
        if not bool((diff <= atol + rtol * r.abs()).all()):
            failed.append(f"element {(rtol, atol)}")
        row = diff.norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
        worst_row = max(worst_row, float(row.max()))
    if worst_row > ROW_TOL[dtype]:
        failed.append(f"row {ROW_TOL[dtype]}")
    return worst, worst_row, failed


def sweep(torch, label, region, run, plain_out, dtype, timer, counter, errors,
          tol=None):
    """Launch every emitted point, compare each with the plain version,
    time each; returns (max error, worst row error, {pp_key: ms})."""
    from repro_torch.core import pp_key

    before = counter.launches
    worst, worst_row, times = 0.0, 0.0, {}
    points = list(region.space.points())
    for point in points:
        out = run(point)
        torch.cuda.synchronize()
        err, row, failed = max_err(torch, outputs(out), plain_out, dtype, tol)
        worst, worst_row = max(worst, err), max(worst_row, row)
        if failed:
            errors.append(f"{label} {point}: max abs error {err}, row error {row}; "
                          f"failed {failed}")
        times[pp_key(point)] = timer.ms(lambda: run(point), reps=5)
    if counter.launches - before < len(points):
        errors.append(f"{label}: {counter.launches - before} launches for {len(points)} points")
    best = min(times, key=times.get)
    print(f"[kernel] {label}: {len(points)} candidates, max abs err {worst:.3e} "
          f"(tol {tol or TOL[dtype]}), row error {worst_row:.3e} (tol {ROW_TOL[dtype]}), "
          f"fastest {best} {times[best]:.4f} ms")
    print(f"[sweep] {label}: " + json.dumps(
        {k: round(v, 4) for k, v in sorted(times.items(), key=lambda kv: kv[1])}))
    return worst, worst_row, times


def check_points(torch, label, points, run, plain_out, dtype, counter, errors, tol=None):
    """Launch each point once and hold it against the plain version;
    returns (max error, worst row error)."""
    before = counter.launches
    worst, worst_row = 0.0, 0.0
    for point in points:
        out = run(point)
        torch.cuda.synchronize()
        err, row, failed = max_err(torch, outputs(out), plain_out, dtype, tol)
        worst, worst_row = max(worst, err), max(worst_row, row)
        if failed:
            errors.append(f"{label} {point}: max abs error {err}, row error {row}; "
                          f"failed {failed}")
    if counter.launches - before < len(points):
        errors.append(f"{label}: {counter.launches - before} launches for {len(points)} points")
    print(f"[kernel] {label}: {len(points)} points, max abs err {worst:.3e}, "
          f"row error {worst_row:.3e}")
    return worst, worst_row


def check_ssm_smem(ssm_mod, region, N, dtype, optin, errors):
    """Each point's shared memory: the Python model against the compiled
    source's, within the card's limit, and its threads within the launch
    bound."""
    elt = ssm_mod.DTYPES[dtype]
    for point in region.space.points():
        model = ssm_mod.smem_bytes(point["block_d"], point["chunk"], N, elt)
        native = ssm_mod.smem_bytes_native(point["block_d"], point["chunk"], N, elt)
        threads = point["block_d"] * ssm_mod.pad_states(N) // point["states"]
        if (model != native or model > optin
                or threads > ssm_mod.max_threads_native(point["states"])):
            errors.append(f"ssm_scan N={N} {dtype} {point}: smem model {model}, kernel "
                          f"{native}, limit {optin}; {threads} threads")


def sweep_once(torch, label, region, run, plain_out, timer, counter, errors):
    """Launch every point of ``region`` once, timed (L2 flushed, CUDA events
    around the call) and held against the plain version in float32;
    returns (max error, worst row error, {pp_key: ms})."""
    from repro_torch.core import pp_key
    from repro_torch.core.cost import _timed

    before = counter.launches
    worst, worst_row, times = 0.0, 0.0, {}
    points = list(region.space.points())
    for point in points:
        got = []

        def call(point=point):
            got.append(run(point))
            return got[-1]

        times[pp_key(point)] = _timed(call, timer.flush) * 1e3
        err, row, failed = max_err(torch, outputs(got[-1]), plain_out, "float32")
        worst, worst_row = max(worst, err), max(worst_row, row)
        if failed:
            errors.append(f"{label} {point}: max abs error {err}, row error {row}; "
                          f"failed {failed}")
    if counter.launches - before < len(points):
        errors.append(f"{label}: {counter.launches - before} launches for {len(points)} points")
    best = min(times, key=times.get)
    print(f"[kernel] {label}: {len(points)} candidates, max abs err {worst:.3e} "
          f"(tol {TOL['float32']}), row error {worst_row:.3e}, fastest {best} "
          f"{times[best]:.4f} ms")
    print(f"[sweep] {label}: " + json.dumps(
        {k: round(v, 4) for k, v in sorted(times.items(), key=lambda kv: kv[1])}))
    return worst, worst_row, times


def bwd_err(torch, out, ref, dtype: str, summed) -> tuple:
    """(max abs error, worst row error, list of the checks failed) of a scan
    backward's gradients against the plain version's: in float32 the
    outputs ``summed`` (indices) to a worst row of SUM_ROW_TOL and the rest
    to SCAN_TOL per element and the float32 row rule; in bf16 every output
    to the bf16 element and row tolerances."""
    worst, worst_row, failed = 0.0, 0.0, []
    for i, (o, r) in enumerate(zip(out, ref)):
        o, r = o.double(), r.double()
        if o.shape != r.shape or not bool(torch.isfinite(o).all()):
            return math.inf, math.inf, [f"output {i} shape/finite"]
        diff = (o - r).abs()
        worst = max(worst, float(diff.max()))
        rows = (diff.reshape(-1, diff.shape[-1]).norm(dim=-1)
                / r.reshape(-1, r.shape[-1]).norm(dim=-1).clamp_min(1e-30))
        row = float(rows.max())
        worst_row = max(worst_row, row)
        if dtype == "float32" and i in summed:
            if row > SUM_ROW_TOL:
                failed.append(f"output {i} row {SUM_ROW_TOL}")
            continue
        rtol, atol = SCAN_TOL if dtype == "float32" else TOL[dtype]
        if not bool((diff <= atol + rtol * r.abs()).all()):
            failed.append(f"output {i} element {(rtol, atol)}")
        if row > ROW_TOL[dtype]:
            failed.append(f"output {i} row {ROW_TOL[dtype]}")
    return worst, worst_row, failed


def scan_bwd_bound_ms(arch, name, shape, elt) -> tuple:
    """(ms, what bounds it, the SFU's ms) of a scan backward: the bytes its
    inputs and gradients must move once at the memory rate, against, for
    ssm_scan, one exp per (t, d, n) on the SFU, for rglru_scan its
    operations at the float32 rate."""
    from repro_torch.kernels.rglru_scan import rglru_scan as rg_mod
    from repro_torch.kernels.ssm_scan import ssm_scan as ssm_mod

    if name == "ssm_scan":
        B, S, D, N = (shape[k] for k in ("B", "S", "D", "N"))
        _, bytes_ = ssm_mod.bwd_traffic(B, S, D, N, elt)
        ops = ssm_mod.sfu_seconds(B, S, D, N, arch.peak_flops_fp32)
    else:
        B, S, W = (shape[k] for k in ("B", "S", "W"))
        flops, bytes_ = rg_mod.bwd_traffic(B, S, W, elt)
        ops = flops / arch.peak_flops_fp32
    by_bytes = bytes_ / arch.hbm_bandwidth
    return max(by_bytes, ops) * 1e3, ("bytes" if by_bytes >= ops else "operations"), ops * 1e3


def scan_bwd_phase(torch, arch, timer, optin, errors) -> dict:
    """Every emitted point of ``ssm_scan_bwd`` and ``rglru_scan_bwd`` at
    SSM_BWD_SHAPES and RGLRU_BWD_SHAPES against the plain backward run on
    the same inputs in float64 (float32 inputs) or float32 (bf16), each
    called twice for the same bits and timed; its shared memory and scratch
    against the compiled source's; the fastest point beside the bound and
    the forward kernel's time at the same shape (at the forward hint's
    first point).  Returns {(name, dtype, tag): case}."""
    from repro_torch.core import pp_key
    from repro_torch.core.search import default_prescreen_k
    from repro_torch.kernels.rglru_scan import ops as rg_ops, ref as rg_ref, rglru_scan as rg_mod
    from repro_torch.kernels.ssm_scan import ops as ssm_ops, ref as ssm_ref, ssm_scan as ssm_mod

    device = torch.device("cuda:0")
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    cases = {}
    for name, shapes in (("ssm_scan", SSM_BWD_SHAPES), ("rglru_scan", RGLRU_BWD_SHAPES)):
        for shape, dtypes in shapes:
            if name == "ssm_scan":
                B, S, D, N = (shape[k] for k in ("B", "S", "D", "N"))
                x, dt, A, Bc, Cc, Dp = ssm_ref.make_inputs(gen, device=device, **shape)
                dy = torch.randn((B, S, D), generator=gen, device=device)
                dh = torch.randn((B, D, N), generator=gen, device=device)
                tag = f"({B},{S},{D},N={N})"
            else:
                B, S, W = (shape[k] for k in ("B", "S", "W"))
                x, r, i, lam = rg_ref.make_inputs(gen, device=device, **shape)
                dy = torch.randn((B, S, W), generator=gen, device=device)
                tag = f"({B},{S},{W})"
            for dtype_name in dtypes:
                dtype = getattr(torch, dtype_name)
                elt = 2 if dtype == torch.bfloat16 else 4
                work = torch.float64 if dtype == torch.float32 else torch.float32
                if name == "ssm_scan":
                    args = (x.to(dtype), dt.to(dtype), A, Bc.to(dtype), Cc.to(dtype), Dp,
                            dy.to(dtype), dh)
                    plain, kernel = ssm_mod.ssm_scan_bwd_plain, ssm_mod.ssm_scan_bwd_cuda
                    region = ssm_ops.ssm_bwd_region(D, S, N, B, arch=arch, dtype=dtype_name)
                    fregion = ssm_ops.ssm_region(D, S, N, B, arch=arch, dtype=dtype_name)
                    forward = ssm_mod.ssm_scan_cuda
                    for p in region.space.points():
                        tiles = (p["block_d"], p["chunk"], N, p["seg"], p["channels"], elt)
                        model = ssm_mod.bwd_smem_bytes(*tiles)
                        native = ssm_mod.bwd_smem_bytes_native(*tiles)
                        scratch = (ssm_mod.bwd_scratch_bytes(B, S, D, N, p["block_d"], p["chunk"]),
                                   ssm_mod.bwd_scratch_bytes_native(B, S, D, N, p["block_d"],
                                                                    p["chunk"]))
                        bound = (ssm_mod.bwd_max_threads(p["seg"], p["channels"]),
                                 ssm_mod.bwd_max_threads_native(p["seg"], p["channels"]))
                        if (model != native or model > optin or scratch[0] != scratch[1]
                                or bound[0] != bound[1]):
                            errors.append(f"ssm_scan bwd {tag} {p}: smem model {model}, kernel "
                                          f"{native}, limit {optin}; scratch {scratch}; "
                                          f"threads bound {bound}")
                else:
                    args = (x.to(dtype), r.to(dtype), i.to(dtype), lam, dy.to(dtype))
                    plain, kernel = rg_mod.rglru_scan_bwd_plain, rg_mod.rglru_scan_bwd_cuda
                    region = rg_ops.rglru_bwd_region(W, S, B, arch=arch, dtype=dtype_name)
                    fregion = rg_ops.rglru_region(W, S, B, arch=arch, dtype=dtype_name)
                    forward = rg_mod.rglru_scan_cuda
                    for p in region.space.points():
                        model = rg_mod.bwd_smem_bytes(p["block_w"], p["chunk"], p["split"], elt)
                        native = rg_mod.bwd_smem_bytes_native(p["block_w"], p["chunk"],
                                                              p["split"], elt)
                        ck = min(p["chunk"], S)
                        scratch = (rg_mod.bwd_scratch_bytes(B, S, W, ck),
                                   rg_mod.bwd_scratch_bytes_native(B, S, W, ck))
                        bound = (rg_mod.bwd_max_threads(ck, p["split"]),
                                 rg_mod.bwd_max_threads_native(ck, p["split"]))
                        if (model != native or model > optin or scratch[0] != scratch[1]
                                or bound[0] != bound[1]):
                            errors.append(f"rglru_scan bwd {tag} {p}: smem model {model}, "
                                          f"kernel {native}, limit {optin}; scratch {scratch}; "
                                          f"threads bound {bound}")
                ref = plain(*(t.to(work) for t in args))
                counter = ssm_mod.bwd_counter if name == "ssm_scan" else rg_mod.bwd_counter
                before = counter.launches
                points = list(region.space.points())
                worst, worst_row, times, differ = 0.0, 0.0, {}, []
                for point in points:
                    out = kernel(*args, **point)
                    torch.cuda.synchronize()
                    err, row, failed = bwd_err(torch, out, ref, dtype_name,
                                               SCAN_BWD_SUMMED[name])
                    worst, worst_row = max(worst, err), max(worst_row, row)
                    if failed:
                        errors.append(f"{name} bwd {dtype_name} {tag} {point}: max abs error "
                                      f"{err}, row error {row}; failed {failed}")
                    if not all(torch.equal(a, b) for a, b in zip(out, kernel(*args, **point))):
                        differ.append(point)
                    del out
                    times[pp_key(point)] = timer.ms(lambda: kernel(*args, **point), reps=3)
                if counter.launches - before < 2 * len(points):
                    errors.append(f"{name} bwd {tag}: {counter.launches - before} launches for "
                                  f"{len(points)} points")
                if differ:
                    errors.append(f"{name} bwd {dtype_name} {tag}: two calls differ at {differ}")
                best = min(times, key=times.get)
                bound, by, sfu = scan_bwd_bound_ms(arch, name, shape, elt)
                floor = "the SFU's exps" if name == "ssm_scan" else "operations"
                fpoint = min(fregion.space.points(),
                             key=lambda p: fregion.hints[pp_key(p)]["est_s"])
                fwd_ms = timer.ms(lambda: forward(*args[:6 if name == "ssm_scan" else 4],
                                                  **fpoint), reps=5)
                print(f"[kernel] {name} bwd {dtype_name} {tag}: {len(points)} candidates, max "
                      f"abs err {worst:.3e}, row error {worst_row:.3e}; two calls of each "
                      f"bit-identical: {not differ}; fastest {best} {times[best]:.4f} ms, bound "
                      f"{bound:.4f} ms ({by}; {floor} {sfu:.4f} ms), "
                      f"{times[best] / bound:.2f}x; forward at {pp_key(fpoint)} {fwd_ms:.4f} ms, "
                      f"backward / forward {times[best] / fwd_ms:.2f}")
                print(f"[sweep] {name} bwd {dtype_name} {tag}: " + json.dumps(
                    {k: round(v, 4) for k, v in sorted(times.items(), key=lambda kv: kv[1])}))
                # the staged search's pick: the best measured of the hint's
                # first default_prescreen_k points
                ranked = sorted(points, key=lambda p: region.hints[pp_key(p)]["est_s"])
                finals = [pp_key(p) for p in ranked[:default_prescreen_k(len(points))]]
                staged = min(finals, key=times.get)
                print(f"[hint] {name} bwd {dtype_name} {tag}: staged pick {staged} "
                      f"{times[staged]:.4f} ms of {len(finals)} finals, fastest {best} "
                      f"{times[best]:.4f} ms; within 10%: {times[staged] <= 1.1 * times[best]}")
                phases = None
                if ((name == "ssm_scan" and (B, S, D, N) == (2, 2048, 8192, 16))
                        or (name == "rglru_scan" and (B, S, W) == (1, 2048, 2560)
                            and dtype_name == "float32")):
                    # the phases at the fastest point: ssm_scan's trips' maps
                    # and their chaining, sweep 2, the reduce; rglru_scan's
                    # maps, chain, gradients, reduce
                    mod = ssm_mod if name == "ssm_scan" else rg_mod
                    phases = bwd_pass_ms(torch, mod.bwd_phase_runs(*args, **json.loads(best)),
                                         timer.flush)
                    print(f"[kernel] {name} bwd phases {dtype_name} {tag} at {best}: "
                          + ", ".join(f"{k} {v:.4f} ms" for k, v in phases.items()))
                for point in points:  # the hint's rank beside the card's
                    hint = region.hints[pp_key(point)]
                    print(f"[hint] {name} bwd {dtype_name} {tag} {pp_key(point)}: est "
                          f"{hint['est_s'] * 1e3:.4f} ms (latency {hint['latency_s'] * 1e3:.4f}), "
                          f"measured {times[pp_key(point)]:.4f} ms")
                cases[(name, dtype_name, tag)] = {
                    "shape": shape, "dtype": dtype_name, "times": times,
                    "candidates": len(points), "max_abs_err": worst, "max_row_err": worst_row,
                    "fastest_point": json.loads(best), "fastest_ms": times[best],
                    "bound_ms": bound, "bound_by": by, "sfu_ms": sfu,
                    "forward_point": fpoint, "forward_ms": fwd_ms, "phases_ms": phases,
                    "staged_point": json.loads(staged), "staged_ms": times[staged]}
                del ref
            torch.cuda.empty_cache()
    return cases


def event_ms(torch, fn, reps: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` runs after a warm one,
    CUDA events around each, in ms (no flush: a model step's own state)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def worst_row(torch, got, ref) -> float:
    """The worst row's ||got - ref|| / ||ref|| over the last axis."""
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        return math.inf
    return float(((got - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)).max())


def model_kernels(cfg) -> dict:
    """The kernel launches one prefill of ``cfg`` makes: one flash call a
    causal self-attention layer (a hybrid's at S <= its window), one scan
    a recurrent layer."""
    if cfg.family == "ssm":
        return {"flash_attention": 0, "ssm_scan": cfg.n_layers, "rglru_scan": 0}
    if cfg.family == "hybrid":
        kinds = [cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.n_layers)]
        return {"flash_attention": kinds.count("attn"), "ssm_scan": 0,
                "rglru_scan": kinds.count("rec")}
    return {"flash_attention": cfg.n_layers, "ssm_scan": 0, "rglru_scan": 0}


def decode_bytes(tm, cfg, ctx: int) -> float:
    """Bytes one decode step of one row must move at ``ctx`` cached
    positions (:func:`decode_step_bytes`)."""
    return decode_step_bytes(tm, cfg, [ctx])


def decode_step_bytes(tm, cfg, ctxs) -> float:
    """Bytes one decode step over rows at ``ctxs`` cached positions must
    move: every weight once (the embedding table only where it is also the
    unembedding: a lookup gathers one row), and for each row the K/V
    positions it attends and each recurrent state read and written."""
    n = tm.count_params(tm.param_specs(cfg))
    weights = 2.0 * (n - (0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model))
    kinds = model_kernels(cfg)
    kv_row = 2.0 * 2 * cfg.n_kv_heads * cfg.head_dim_ * kinds["flash_attention"]
    if cfg.family == "hybrid":
        kv = kv_row * sum(min(c, cfg.local_window) for c in ctxs)
    else:
        kv = kv_row * sum(ctxs)
    state = 0.0
    if cfg.family == "ssm":
        state = cfg.n_layers * 2 * (4.0 * cfg.d_inner * cfg.ssm_state
                                    + 2.0 * (cfg.d_conv - 1) * cfg.d_inner)
    elif cfg.family == "hybrid":
        state = kinds["rglru_scan"] * 2 * (4.0 * cfg.lru_width_
                                           + 2.0 * (cfg.d_conv - 1) * cfg.lru_width_)
    return weights + kv + state * len(ctxs)


def profiled(torch, fn):
    """One ``torch.profiler`` run of ``fn``, host and device."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def device_rows(torch, fn, prof=None) -> list:
    """(kernel name, device ms) of every device kernel in one
    ``torch.profiler`` run of ``fn`` (or in ``prof``), most time first."""
    from torch.autograd import DeviceType

    rows = []
    for evt in (prof or profiled(torch, fn)).key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue  # a host op: its kernels are rows of their own
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0.0)
        rows.append((evt.key, t / 1e3))
    return sorted(rows, key=lambda r: -r[1])


def kernel_share(torch, fn) -> tuple:
    """(device ms of the hand-written kernels, device ms of everything, the
    eight entries with the most device time as (name, ms)) in one
    ``torch.profiler`` run of ``fn``; (None, None, []) if it saw no device
    time."""
    rows = device_rows(torch, fn)
    total = sum(t for _, t in rows)
    ours = sum(t for key, t in rows
               if any(name in key for names in KERNEL_ENTRIES.values() for name in names))
    if total <= 0:
        return None, None, []
    return ours, total, [(key[:80], t) for key, t in rows[:8]]


# the training step's device time by kind of kernel (first match)
STEP_KINDS = (("flash_forward", ("flash_fwd",)), ("flash_backward", ("flash_bwd",)),
              ("ssm_scan_forward", ("ssm_kernel",)), ("ssm_scan_backward", ("ssm_bwd",)),
              ("rglru_scan_forward", ("rglru_kernel",)),
              ("rglru_scan_backward", ("rglru_bwd",)),
              ("gemm", ("gemm", "nvjet", "xmma", "cutlass")))


def step_profile(torch, fn) -> dict:
    """Device ms of one run of ``fn`` by :data:`STEP_KINDS` and the rest,
    with the total and the ten kernels with the most time.  A kind's ms is
    the union of its kernels' spans on the device: a kernel launched as a
    programmatic dependent (``rglru_scan_bwd``'s chain, gradient and reduce
    launches) starts while the one before it drains, and a sum of
    durations would count that overlap twice."""
    from torch.autograd import DeviceType

    prof = profiled(torch, fn)
    spans = {kind: [] for kind, _ in STEP_KINDS}
    spans["rest"] = []
    for evt in prof.events():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        kind = next((kind for kind, names in STEP_KINDS
                     if any(n in evt.name.lower() for n in names)), "rest")
        spans[kind].append((evt.time_range.start, evt.time_range.end))
    kinds = {}
    for kind, intervals in spans.items():
        busy, reach = 0.0, float("-inf")
        for start, end in sorted(intervals):
            busy += max(0.0, end - max(start, reach))
            reach = max(reach, end)
        kinds[kind] = busy / 1e3
    rows = device_rows(torch, fn, prof)
    return {"device_ms": sum(kinds.values()), "by_kind_ms": kinds,
            "top": [(key[:80], t) for key, t in rows[:10]]}


def temper(torch, tm, params) -> None:
    """Draw the attention projections at the fan-in of d_model, in place:
    the JAX init rules take a (d, heads, hd) projection's fan-in as its
    second-to-last dim (the heads), so its scores grow with d / heads
    (std ~180 in tinyllama-1.1b's first layer) and the model is chaotic:
    a one-ulp bf16 change flips which key a softmax picks.  wq and wk are
    scaled by sqrt(heads / d_model), which gives scores of about unit
    scale; every other weight is as drawn."""
    with torch.no_grad():
        for module in params.modules():
            if isinstance(module, tm.Params) and "wq" in module and "wk" in module:
                for name in ("wq", "wk"):
                    w = module[name]
                    w.mul_(math.sqrt(w.shape[1] / w.shape[0]))


class KernelCalls:
    """Records every call the model path makes to a kernel route (its
    inputs and output), to hold each against the kernel's plain version on
    the same inputs afterwards; with ``this_thread`` only the calls made on
    the thread that enters (the serving thread, not a background tuner's)."""

    def __init__(self, this_thread: bool = False):
        self.calls = []
        self._patches = []
        self._thread = threading.get_ident() if this_thread else None

    def __enter__(self):
        from repro_torch.models import encdec, rglru, ssm, transformer

        for module, name in ((transformer, "causal_attention"), (encdec, "causal_attention"),
                             (ssm, "selective_scan"), (rglru, "lru_scan")):
            fn = getattr(module, name)
            self._patches.append((module, name, fn))

            def record(*args, _fn=fn, _name=name, **kwargs):
                out = _fn(*args, **kwargs)
                if self._thread is None or self._thread == threading.get_ident():
                    self.calls.append((_name, args, kwargs, out))
                return out

            setattr(module, name, record)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._patches:
            setattr(module, name, fn)
        return False


def check_calls(torch, label, calls, errors, tag: str = "model") -> dict:
    """Each recorded kernel call against its plain version on the same
    inputs: flash against ``attention_plain``, held to the worst-row rule
    (the element tolerance assumes outputs of unit scale, and the model's
    are not: at the JAX init its outputs reach tens, where one bf16 ulp is
    0.125-0.5, and a softmax near a tie of two such values of opposite
    sign gives outputs near 0); the scans' routes
    run on their plain versions, held to the scans' f32 tolerance; returns
    {route: (calls, max abs error, worst row, largest |output|)}."""
    from repro_torch import models as tm
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.models import rglru, ssm

    out = {}
    for name, args, kwargs, got in calls:
        if name == "causal_attention":
            ref = fa_mod.attention_plain(*args)
            dtype, tol = str(args[0].dtype).replace("torch.", ""), None
        else:
            with tm.plain_versions():
                ref = (ssm.selective_scan if name == "selective_scan" else rglru.lru_scan)(
                    *args, **kwargs)
            dtype, tol = "float32", SCAN_TOL
        err, row, failed = max_err(torch, outputs(got), outputs(ref), dtype, tol)
        if name == "causal_attention":
            failed = [f for f in failed if not f.startswith("element")]
        n, e, r, m = out.get(name, (0, 0.0, 0.0, 0.0))
        out[name] = (n + 1, max(e, err), max(r, row),
                     max(m, max(float(t.abs().max()) for t in outputs(ref))))
        if failed:
            errors.append(f"{label}: {name} call {n} off its plain version by {err}, row "
                          f"{row}; failed {failed}")
    for name, (n, err, row, scale) in out.items():
        print(f"[{tag}] {label}: {n} {name} calls of a prefill against the plain version on "
              f"the same inputs: max abs err {err:.3e} (largest |output| {scale:.3e}), worst "
              f"row {row:.3e}")
    return out


def model_phase(torch, arch, depth, steps, device, arch_spec, counters, tuned_fps, errors):
    """One full-width model on the card: prefill and greedy decode through
    the model zoo's entry points on the kernel route, each kernel's
    launches and the evaluations it spent tuning, each kernel call of a
    prefill against its plain version on the same inputs; then, on the
    same weights with the attention projections tempered (:func:`temper`),
    the kernel route's last logits against the plain versions' and decode
    after prefill (with the JAX init's weights both are reported, not
    checked: the model is chaotic there).  Returns the phase's record."""
    from repro_torch import models as tm
    from repro_torch.configs import get_config
    from repro_torch.core import autotuned

    cfg = get_config(arch)
    if depth is not None:
        cfg = cfg.with_(n_layers=depth)
    label = f"{arch} (depth {cfg.n_layers})"
    gen = torch.Generator(device=device).manual_seed(SEED)
    t0 = time.perf_counter()
    params = tm.init_params(cfg, gen, device)
    prompt = torch.randint(0, cfg.vocab_size - 1, (1, MODEL_S + 1), generator=gen, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = {"tokens": prompt[:, :MODEL_S]}
    cap = MODEL_S + steps

    def prefill():
        return tm.prefill_fn(params, batch, cfg, capacity=cap)

    ops = {name: autotuned(name) for name in counters}
    before = {name: set(op.states()) for name, op in ops.items()}
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    logits, _ = prefill()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    evaluations = {}
    for name, op in ops.items():
        for fp, state in op.states().items():
            if fp in before[name]:
                continue
            bp = state.bp.asdict()
            evaluations[f"{name} {bp}"] = state.cost_evaluations
            print(f"[model] {label}: {name} shape class {bp}: {state.cost_evaluations} "
                  f"evaluations, from_cache={state.from_cache}, tuned by a kernel phase: "
                  f"{fp in tuned_fps}")
            if fp in tuned_fps and (state.cost_evaluations or not state.from_cache):
                errors.append(f"{label}: {name} re-tuned a shape class a kernel phase tuned")
    # a steady prefill: every kernel launched by its wrapper, none plain,
    # each call recorded and held against its plain version after
    for c in counters.values():
        c.reset()
    with KernelCalls() as rec:
        logits, cache = prefill()
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    plain = sum(c.plain_calls for c in counters.values())
    expected = model_kernels(cfg)
    print(f"[model] {label}: prefill launches {launches} (expected {expected}), plain-version "
          f"calls {plain}; init {init_s:.2f} s, cold prefill {cold_s:.2f} s")
    if launches != expected or plain:
        errors.append(f"{label}: prefill launches {launches}, plain calls {plain}; "
                      f"expected {expected} and 0")
    if tuple(logits.shape) != (1, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        errors.append(f"{label}: prefill logits {tuple(logits.shape)} not finite")
    per_call = check_calls(torch, label, rec.calls, errors)
    del rec
    prefill_ms = event_ms(torch, prefill, reps=5)

    def greedy(logits, cache, n):
        tok = logits.argmax(-1, keepdim=True)
        for _ in range(n):
            logits, cache = tm.decode_fn(params, {"tokens": tok}, cache, cfg)
            tok = logits.argmax(-1, keepdim=True)
        return logits

    for c in counters.values():
        c.reset()
    greedy(logits, cache, steps)  # warm
    decode_launches = {name: c.launches for name, c in counters.items()}
    logits, cache = prefill()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    last = greedy(logits, cache, steps)
    end.record()
    torch.cuda.synchronize()
    decode_ms = start.elapsed_time(end) / steps
    if not bool(torch.isfinite(last).all()):
        errors.append(f"{label}: decode logits not finite")
    ours_ms, device_ms, top = kernel_share(torch, prefill)

    def end_to_end(gate: bool) -> tuple:
        """The kernel route's last logits against the plain versions' on
        the card, and decode after prefill (prompt[:S] + one step against
        prefill of prompt[:S+1])."""
        what = "tempered" if gate else "JAX init"
        ours, _ = prefill()
        for c in counters.values():
            c.reset()
        with tm.plain_versions():
            theirs, _ = prefill()
        plain_calls = {name: c.plain_calls for name, c in counters.items()}
        vs_plain = worst_row(torch, ours, theirs)
        s = MODEL_CHECK_S
        full, _ = tm.prefill_fn(params, {"tokens": prompt[:, :s + 1]}, cfg)
        _, short = tm.prefill_fn(params, {"tokens": prompt[:, :s]}, cfg, capacity=s + 1)
        step, _ = tm.decode_fn(params, {"tokens": prompt[:, s:s + 1]}, short, cfg)
        gap = (step.float() - full.float()).abs()
        dap_ok = bool((gap <= 0.08 + 0.1 * full.float().abs()).all())
        dap_row = worst_row(torch, step, full)
        print(f"[model] {label}, {what} weights: kernel route vs plain versions, last logits "
              f"worst row {vs_plain:.3e} (tol {ROW_TOL['bfloat16']}); decode after prefill at "
              f"S={s}: max abs {float(gap.max()):.3e}, worst row {dap_row:.3e}, within "
              f"(rtol 0.1, atol 0.08): {dap_ok}; plain calls {plain_calls}"
              + ("" if gate else " (reported, not checked)"))
        if gate and (vs_plain > ROW_TOL["bfloat16"] or plain_calls != expected):
            errors.append(f"{label}: kernel route off the plain versions by {vs_plain} "
                          f"(plain calls {plain_calls})")
        if gate and not dap_ok:
            errors.append(f"{label}: decode after prefill off prefill by {float(gap.max())}")
        return vs_plain, dap_row

    raw = end_to_end(gate=False)
    temper(torch, tm, params)
    tempered = end_to_end(gate=True)

    flops = tm.analytic_step_flops(cfg, "prefill", 1, MODEL_S)
    prefill_bound = flops / arch_spec.peak_flops * 1e3
    dbytes = decode_bytes(tm, cfg, MODEL_S + steps // 2)
    decode_bound = dbytes / arch_spec.hbm_bandwidth * 1e3
    share = None if device_ms is None else ours_ms / device_ms
    print(f"[model] {label}: prefill {prefill_ms:.3f} ms (bound {prefill_bound:.3f} ms, "
          f"{flops:.3e} FLOP); decode {decode_ms:.3f} ms a token over {steps} steps (bound "
          f"{decode_bound:.3f} ms, {dbytes:.3e} B); kernel launches in decode "
          f"{decode_launches}; hand-written kernels {ours_ms} of {device_ms} device ms in one "
          f"profiled prefill (share {share})")
    for name, ms in top:
        print(f"[profile] {label}: {ms:.3f} ms {name}")
    return {"arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model, "seq": MODEL_S,
            "decode_steps": steps, "prefill_ms": prefill_ms, "prefill_bound_ms": prefill_bound,
            "prefill_flops": flops, "decode_ms_per_token": decode_ms,
            "decode_bound_ms": decode_bound, "decode_bytes": dbytes, "launches": launches,
            "decode_launches": decode_launches, "evaluations": evaluations,
            "per_call": per_call, "vs_plain_worst_row": tempered[0],
            "decode_after_prefill_worst_row": tempered[1], "jax_init_vs_plain_worst_row": raw[0],
            "jax_init_decode_after_prefill_worst_row": raw[1],
            "kernel_ms": ours_ms, "device_ms": device_ms, "kernel_share": share,
            "top_device_ms": top, "init_s": init_s, "cold_prefill_s": cold_s}


def smoke_sweep(torch, device, errors) -> dict:
    """Every arch at its SMOKE config: prefill and SMOKE_STEPS decode steps
    on the card against the port's own CPU run on the same weights, the
    attention projections tempered (:func:`temper`; decode fed the CPU's
    greedy tokens); returns {arch: worst row}."""
    import copy

    from repro_torch import models as tm
    from repro_torch.configs import ARCH_IDS, get_config

    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=True)
        params = tm.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
        temper(torch, tm, params)
        on_card = copy.deepcopy(params).to(device)
        S = cfg.local_window + 8 if cfg.family == "hybrid" else 16
        batch = tm.make_concrete_batch(torch.Generator().manual_seed(SEED), cfg, "prefill", 2,
                                       S, "cpu")["batch"]
        card_batch = {k: v.to(device) for k, v in batch.items()}
        ref, ref_cache = tm.prefill_fn(params, batch, cfg, capacity=S + SMOKE_STEPS)
        got, cache = tm.prefill_fn(on_card, card_batch, cfg, capacity=S + SMOKE_STEPS)
        rows = [worst_row(torch, got.cpu(), ref)]
        extra = {"frames": batch["frames"]} if cfg.is_encoder_decoder else {}
        for _ in range(SMOKE_STEPS):
            tok = ref.argmax(-1, keepdim=True)
            ref, ref_cache = tm.decode_fn(params, {"tokens": tok, **extra}, ref_cache, cfg)
            got, cache = tm.decode_fn(on_card, {"tokens": tok.to(device)}, cache, cfg)
            rows.append(worst_row(torch, got.cpu(), ref))
        out[arch] = max(rows)
        print(f"[model] smoke {arch}: card vs CPU, prefill and {SMOKE_STEPS} decode steps, "
              f"worst row {out[arch]:.3e} (tol {ROW_TOL['bfloat16']})")
        if out[arch] > ROW_TOL["bfloat16"]:
            errors.append(f"smoke {arch}: card off the CPU run by {out[arch]}")
    return out


# ---------------------------------------------------------------------------
# [serve]: the serving slice (repro_torch.runtime) on the card
# ---------------------------------------------------------------------------


def serve_setup(torch, arch, depth, device):
    """(cfg, tempered bf16 params on ``device``) of one full-width model."""
    from repro_torch import models as tm
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if depth is not None:
        cfg = cfg.with_(n_layers=depth)
    params = tm.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    temper(torch, tm, params)
    return cfg, params


def serve_oracle(cfg, params, reqs, max_len, batch=None) -> tuple:
    """(rid -> tokens, rid -> the logits row behind each token) of the
    port's one-request-at-a-time oracle: ``Server(batch_size=1)``, request
    by request, no tuning.  With ``batch``, each prompt is first left-padded
    with token 0 to the length of its group of ``batch`` requests
    (:func:`padded_prompt`): the static Server's inputs, which (as the JAX
    Server's) pad without a mask, so a row's tokens depend on its
    batch-mates' prompt lengths."""
    from repro_torch.data import ServingRequest
    from repro_torch.runtime import Server

    srv = Server(cfg, params, batch_size=1, max_len=max_len)
    alone = [ServingRequest(rid=r.rid, prompt=padded_prompt(reqs, i, batch),
                            max_new_tokens=r.max_new_tokens) for i, r in enumerate(reqs)]
    out = {}
    with LogitsRecorder() as rec:
        for r in alone:
            out.update(srv.run([r]))
    return out, witness(server_rows, rec.records, alone, 1)


def padded_prompt(reqs, i, batch):
    """Request i's prompt as the static Server feeds it: left-padded with
    token 0 to the longest prompt of its group of ``batch``."""
    import numpy as np

    prompt = reqs[i].prompt
    if batch is None:
        return prompt
    group = reqs[i - i % batch: i - i % batch + batch]
    plen = max(len(g.prompt) for g in group)
    return np.concatenate([np.zeros(plen - len(prompt), prompt.dtype), prompt])


class LogitsRecorder:
    """The logits behind every greedy token that the Server and the engine
    pick on the entering thread (the serving thread: a background tuner's
    trials are left out), in call order: ``records`` holds (module,
    logits), the logits kept on their device as they are, so recording
    costs a run no copy and no synchronisation."""

    def __enter__(self):
        from repro_torch.runtime import engine, serve

        self.records = []
        self._thread = threading.get_ident()
        self._patches = []
        for module in (serve, engine):
            fn = module.greedy
            self._patches.append((module, fn))

            def record(logits, _fn=fn, _where=module.__name__.rsplit(".", 1)[1]):
                if threading.get_ident() == self._thread:
                    self.records.append((_where, logits))
                return _fn(logits)

            module.greedy = record
        return self

    def __exit__(self, *exc):
        for module, fn in self._patches:
            module.greedy = fn
        return False


def server_rows(records, reqs, batch) -> dict:
    """rid -> the logits row behind each of its tokens in a Server run of
    ``reqs`` at ``batch``: per group its prefill, then its decode steps."""
    logits = [x for where, x in records if where == "serve"]
    rows, k = {}, 0
    for i in range(0, len(reqs), batch):
        group = reqs[i:i + batch]
        steps = logits[k:k + max(r.max_new_tokens for r in group)]
        k += len(steps)
        for gi, r in enumerate(group):
            rows[r.rid] = [x[gi] for x in steps][:r.max_new_tokens]
    if k != len(logits):
        raise RuntimeError(f"{len(logits)} greedy calls for {k} steps of the groups")
    return rows


def engine_rows(records, events) -> dict:
    """rid -> the logits row behind each of its tokens in an engine run,
    laid out by its tracer's steps: a prefill picks one token a row of its
    group (a resumed request starts over), a decode step one a real row,
    over the greedy calls of its degree's chunks."""
    logits = iter([x for where, x in records if where == "engine"])
    rows = {}
    for ev in events:
        if ev["name"] == "engine.prefill":
            x = next(logits)
            for i, rid in enumerate(ev["args"]["rids"]):
                rows[rid] = [x[i]]
        elif ev["name"] == "engine.decode":
            got = []
            while len(got) < ev["args"]["bucket"]:
                got.extend(next(logits).unbind(0))
            for i, rid in enumerate(ev["args"]["rids"]):
                rows[rid].append(got[i])
    if next(logits, None) is not None:
        raise RuntimeError("greedy calls left over after the traced steps")
    return rows


def witness(fn, *args) -> dict:
    """``fn(*args)``, the rows behind a run's greedy tokens; {} (printed)
    where the run's calls do not lay out, and then any parting of that
    run counts as DIFFER."""
    try:
        return fn(*args)
    except (RuntimeError, StopIteration, KeyError, IndexError) as e:
        print(f"[serve] no logits witness: {e!r}")
        return {}


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at ``x`` (8 bits of mantissa)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def parting(want, got, want_rows, got_rows) -> dict:
    """Where ``got`` leaves ``want``, with both witnesses there: each
    path's own logits of the two tokens, recorded in the runs.  ``near``
    when each path picked its token by at most ``NEAR_TIE_ULPS`` bf16 ulps
    (of the larger of the two picked logits) over the other's."""
    j = next((k for k, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if j is None:
        return {"lengths": (len(want), len(got)), "near": False}
    a, b = want[j], got[j]
    info = {"step": j, "of": len(want), "tokens": (a, b), "near": False}
    if not want_rows or not got_rows or j >= min(len(want_rows), len(got_rows)):
        info["witness"] = "not recorded"
        return info
    w, g = want_rows[j].float().cpu(), got_rows[j].float().cpu()
    if int(w.argmax()) != a or int(g.argmax()) != b:
        info["witness"] = f"the rows pick {int(w.argmax())}, {int(g.argmax())}"
        return info
    ulp = bf16_ulp(max(abs(float(w[a])), abs(float(g[b]))))
    gaps = (float(w[a] - w[b]) / ulp, float(g[b] - g[a]) / ulp)
    info.update(reference=(float(w[a]), float(w[b])), run=(float(g[a]), float(g[b])),
                gap_ulps=gaps, near=all(0 <= x <= NEAR_TIE_ULPS for x in gaps))
    return info


def drained(eng, reqs) -> list:
    """What the engine's drain contract misses: every request retired once
    with a valid status, every block free, 0 hot-path evaluations."""
    from repro_torch.runtime.engine import REQUEST_STATUSES

    bad = []
    if set(eng.results) != {r.rid for r in reqs}:
        bad.append(f"retired {sorted(eng.results)} of {sorted(r.rid for r in reqs)}")
    bad += [f"rid {rid} status {res.status}" for rid, res in eng.results.items()
            if res.status not in REQUEST_STATUSES]
    if eng.cache.free != eng.cache.n_blocks or eng.cache.block_table:
        bad.append(f"blocks held: {eng.cache.block_table}")
    if eng.hot_path_cost_evaluations:
        bad.append(f"{eng.hot_path_cost_evaluations} hot-path evaluations")
    return bad


def engine_decode_steps(eng, reqs) -> list:
    """(device-synchronised ms, rows, each row's cached positions) of every
    decode step, from the engine's tracer: a row holds its prompt after
    prefill and one more position each decode step it took part in."""
    plen = {r.rid: len(r.prompt) for r in reqs}
    ctx = {}
    steps = []
    for ev in eng.tracer.events():
        if ev["name"] == "engine.prefill":
            for rid in ev["args"]["rids"]:
                ctx[rid] = plen[rid]
        elif ev["name"] == "engine.decode":
            rids = ev["args"]["rids"]
            steps.append((ev["dur"] / 1e3, len(rids), [ctx[rid] + 1 for rid in rids]))
            for rid in rids:
                ctx[rid] += 1
    return steps


def op_states(srv) -> list:
    """Every class a Server or an engine resolved: its serve ops' and the
    kernel ops' of its serving rule."""
    ops = [srv.prefill_op, srv.decode_op] + ([srv.sched_op] if hasattr(srv, "sched_op") else [])
    return [st for op in ops for st in op.states().values()] + list(srv.rule.states().values())


# the route (the model function that ``KernelCalls`` records) of each kernel
ROUTE_OF = {"flash_attention": "causal_attention", "ssm_scan": "selective_scan",
            "rglru_scan": "lru_scan"}


class ServeRun:
    """One serve run's bookkeeping: its TuningDB and, unless ``tuner`` is
    False, its BackgroundTuner; the kernel counts set to 0 just before it
    and read just after, the serving thread's apart from the tuner's
    trials; the kernel calls of its prefills and the logits of its greedy
    tokens on the serving thread."""

    def __init__(self, torch, label, counters, db=None, tuner=True):
        from repro_torch.core import TuningDB
        from repro_torch.runtime import BackgroundTuner

        self.torch, self.label, self.counters = torch, label, counters
        self.db = db if db is not None else TuningDB()
        self.tuner = BackgroundTuner(name=f"tuner {label}") if tuner else None
        self.launches = self.trial_launches = self.plain = None

    def __enter__(self):
        for c in self.counters.values():
            c.reset()
        self.thread = threading.get_ident()
        self.rec = KernelCalls(this_thread=True).__enter__()
        self.logits = LogitsRecorder().__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.logits.__exit__(*exc)
        self.rec.__exit__(*exc)
        own = {name: c.on_thread(self.thread) for name, c in self.counters.items()}
        self.launches = {name: n for name, (n, _) in own.items()}
        self.trial_launches = {name: c.launches - own[name][0]
                               for name, c in self.counters.items()}
        self.plain = sum(c.plain_calls for c in self.counters.values())  # every thread's
        self.pending = self.tuner.pending if self.tuner is not None else 0
        return False

    def stop_tuner(self, drain_s: float, drop_first=None) -> dict:
        """Drop the queued jobs whose label ``drop_first`` accepts, let the
        tuner go on for ``drain_s`` seconds, drop what it has not started,
        wait for the job it runs; what it did."""
        t0 = time.perf_counter()
        skipped = self.tuner.cancel_pending(drop_first) if drop_first is not None else []
        drained_in = self.tuner.drain(timeout=drain_s)
        dropped = skipped + self.tuner.cancel_pending()
        self.tuner.stop(timeout=300)
        print(f"[time] {self.label}: the tuner stopped {time.perf_counter() - t0:.2f} s "
              f"after the run (drained: {drained_in}; {len(skipped)} dropped first)")
        return {"pending_at_end": self.pending, "drained": drained_in,
                "dropped": len(dropped), "tuned": len(self.tuner.completed),
                "background_evaluations": self.tuner.background_evaluations,
                "errors": [f"{label}: {e!r}" for label, e in self.tuner.errors]}

    def check(self, cfg, errors, expect=None) -> dict:
        """On the serving thread: every expected kernel launched, once for
        each call of its route that :class:`KernelCalls` recorded; no plain
        call on any thread; each prefill kernel call within tolerance of
        its plain version."""
        expect = [k for k, n in model_kernels(cfg).items() if n] if expect is None else expect
        per_call = check_calls(self.torch, self.label, self.rec.calls, errors, tag="serve")
        calls = {k: per_call.get(ROUTE_OF[k], (0,))[0] for k in self.launches}
        missing = [k for k in expect if not self.launches[k] or not calls[k]]
        unmatched = {k: (n, calls[k]) for k, n in self.launches.items() if n != calls[k]}
        if missing or unmatched or self.plain:
            errors.append(f"serve {self.label}: on the serving thread kernels {missing} never "
                          f"launched, (launches, route calls) {unmatched} apart, or "
                          f"{self.plain} plain calls ({self.launches})")
        return per_call


def verdicts(label, want, got, want_rows, got_rows, errors,
             what="the one-at-a-time oracle") -> dict:
    """rid -> "ok" (the tokens equal ``want``'s), "near-tie" (they part
    where both runs' own logits of the two tokens lie within
    ``NEAR_TIE_ULPS`` bf16 ulps: the logits are bf16-rounded, as the JAX
    model's, and a batch of rows rounds a product differently from one
    row) or "DIFFER" (any other parting, or one with no witness: the run
    fails); more than ``NEAR_TIE_RUN_SHARE`` of the requests at near-ties
    fails it too.  Printed, with each parting; returns the counts."""
    out, parts = {}, {}
    for rid in sorted(want):
        if got.get(rid) == want[rid]:
            out[rid] = "ok"
            continue
        parts[rid] = parting(want[rid], got.get(rid) or [], want_rows.get(rid),
                             got_rows.get(rid))
        out[rid] = "near-tie" if parts[rid]["near"] else "DIFFER"
    counts = {v: list(out.values()).count(v) for v in ("ok", "near-tie", "DIFFER")}
    print(f"[serve] {label}: tokens against {what}: {counts}; "
          + " ".join(f"{rid}:{v}" for rid, v in out.items()))
    for rid, info in parts.items():
        print(f"[serve] {label}: request {rid} parts at {info} ({out[rid]})")
    bad = [rid for rid, v in out.items() if v == "DIFFER"]
    if bad:
        errors.append(f"serve {label}: requests {bad} differ from {what}")
    if counts["near-tie"] > NEAR_TIE_RUN_SHARE * len(want):
        errors.append(f"serve {label}: {counts['near-tie']} of {len(want)} requests part at "
                      f"near-ties (at most {NEAR_TIE_RUN_SHARE:.0%})")
    return counts


def serve_report(label, stats_line, run, tuner, classes, hot, want, got, want_rows, got_rows,
                 errors) -> dict:
    print(f"[serve] {label}: {stats_line}")
    print(f"[serve] {label}: {len(classes)} traffic classes {classes}; hot-path evaluations "
          f"{hot}; background: {tuner}")
    print(f"[serve] {label}: kernel launches on the serving thread {run.launches}, the "
          f"tuner's trials {run.trial_launches}, plain calls {run.plain}; wall "
          f"{run.wall_s:.2f} s")
    if hot:
        errors.append(f"serve {label}: {hot} hot-path evaluations")
    if tuner.get("errors"):
        errors.append(f"serve {label}: background tuning failed: {tuner['errors']}")
    return verdicts(label, want, got, want_rows, got_rows, errors)


def serve_tinyllama(torch, device, arch_spec, counters, errors) -> list:
    """tinyllama-1.1b uncut: the Server on a mixed trace (then again on the
    same DB, then joint_tune twice) and the StreamingEngine on a bursty
    trace with its tuner, with none, and on the first run's DB once its
    tuner has drained; every request against the oracle."""
    from repro_torch import models as tm
    from repro_torch.data import bursty_open_loop_trace, mixed_traffic_trace
    from repro_torch.runtime import Server

    cfg, params = serve_setup(torch, "tinyllama-1.1b", None, device)
    stream = bursty_open_loop_trace(cfg, 16, seed=SEED, burst_size=4, burst_gap_s=0.05)
    static = mixed_traffic_trace(cfg, 8, seed=SEED)
    max_len = max(len(r.prompt) + r.max_new_tokens for r in stream + static)
    records = []
    oracle, oracle_rows = serve_oracle(cfg, params, static, max_len, batch=SERVE_BATCH)

    # the Server, batch 4: the tuner drains before the second pass
    label = "tinyllama-1.1b Server"
    with ServeRun(torch, label, counters) as run:
        srv = Server(cfg, params, batch_size=SERVE_BATCH, max_len=max_len, tuning_db=run.db,
                     background_tuner=run.tuner)
        out = srv.run(static)
    per_call = run.check(cfg, errors)
    rows = witness(server_rows, run.logits.records, static, SERVE_BATCH)
    tuner = run.stop_tuner(SERVE_DRAIN_S)
    if not tuner["drained"] or tuner["dropped"]:
        errors.append(f"serve {label}: background tuning did not drain in {SERVE_DRAIN_S} s")
    groups = [static[i:i + SERVE_BATCH] for i in range(0, len(static), SERVE_BATCH)]
    steps = [max(len(r.prompt) for r in g) + k
             for g in groups for k in range(1, max(r.max_new_tokens for r in g))]
    bound = sum(decode_step_bytes(tm, cfg, [ctx + 1] * SERVE_BATCH)
                for ctx in steps) / len(steps) / arch_spec.hbm_bandwidth * 1e3

    def server_line(srv, run):
        """The stats line of a Server run, and (prefill ms a group, decode
        ms a step): a step of the batch's rows, ``steps`` of them."""
        s = srv.stats
        prefill_ms, step_ms = s.prefill_s / len(groups) * 1e3, s.decode_s / len(steps) * 1e3
        return (f"{len(static)} requests, {s.tokens_out} tokens, {s.decode_tok_per_s:.1f} tok/s "
                f"in decode, {s.tokens_out / run.wall_s:.1f} tok/s end to end; prefill "
                f"{prefill_ms:.3f} ms a group of {SERVE_BATCH}; decode {step_ms:.3f} ms a step "
                f"of {SERVE_BATCH} rows (bound {bound:.3f} ms)"), prefill_ms, step_ms

    line, prefill_ms, step_ms = server_line(srv, run)
    s = srv.stats
    oracle_counts = serve_report(label, line, run, tuner, srv.traffic_classes_seen,
                                 srv.hot_path_cost_evaluations, oracle, out, oracle_rows, rows,
                                 errors)
    records.append({"run": label, "requests": len(out), "tokens": s.tokens_out,
                    "decode_tok_per_s": s.decode_tok_per_s, "wall_s": run.wall_s,
                    "prefill_ms_per_group": prefill_ms,
                    "decode_ms_per_step": step_ms, "decode_bound_ms": bound,
                    "launches": run.launches, "trial_launches": run.trial_launches,
                    "per_call": per_call, "tuner": tuner,
                    "classes": srv.traffic_classes_seen, "oracle": oracle_counts})

    # the same trace on the same DB: every class recalled, nothing evaluated
    label = "tinyllama-1.1b Server, second pass"
    with ServeRun(torch, label, counters, db=run.db) as run2:
        srv2 = Server(cfg, params, batch_size=SERVE_BATCH, max_len=max_len,
                      tuning_db=run2.db, background_tuner=run2.tuner)
        out2 = srv2.run(static)
    run2.check(cfg, errors)
    rows2 = witness(server_rows, run2.logits.records, static, SERVE_BATCH)
    states = op_states(srv2)
    evaluations = sum(st.cost_evaluations + st.prescreen_evaluations for st in states)
    recalled = sum(st.from_cache for st in states)
    # joint AT of the serve step, then its recall
    t0 = time.perf_counter()
    joint = srv2.joint_tune(static)
    joint_s = time.perf_counter() - t0
    again = srv2.joint_tune(static)
    tuner2 = run2.stop_tuner(SERVE_DRAIN_S)
    evaluations += tuner2["background_evaluations"]
    print(f"[serve] {label}: {len(states)} classes, {recalled} recalled from the DB, "
          f"{evaluations} evaluations of any kind (must be 0); winners "
          f"{[(st.bp['kernel'], st.region.selected) for st in states]}")
    print(f"[serve] {label}: joint_tune {joint.assignment} in {joint_s:.2f} s, "
          f"{joint.evaluations} evaluations; again: from_cache={again.from_cache}, "
          f"{again.evaluations} evaluations")
    if evaluations or recalled != len(states):
        errors.append(f"serve {label}: {evaluations} evaluations, {recalled} of "
                      f"{len(states)} classes recalled")
    if not again.from_cache or again.evaluations or again.assignment != joint.assignment:
        errors.append(f"serve {label}: joint_tune not recalled ({again})")
    line2, prefill_ms2, step_ms2 = server_line(srv2, run2)
    counts2 = serve_report(label, line2, run2, tuner2, srv2.traffic_classes_seen,
                           srv2.hot_path_cost_evaluations, oracle, out2, oracle_rows, rows2,
                           errors)
    records.append({"run": label, "evaluations": evaluations, "recalled": recalled,
                    "classes": len(states), "joint": joint.assignment,
                    "joint_evaluations": joint.evaluations, "joint_s": joint_s,
                    "prefill_ms_per_group": prefill_ms2, "decode_ms_per_step": step_ms2,
                    "wall_s": run2.wall_s, "launches": run2.launches,
                    "trial_launches": run2.trial_launches, "oracle": counts2})

    # the engine: with its tuner (which then drains the kernel and degree
    # classes: the scheduler's shadow replays would take minutes), with no
    # tuner (the control), and on the drained DB with no tuner (the tuned path)
    label = "tinyllama-1.1b StreamingEngine"
    stream_oracle = serve_oracle(cfg, params, stream, max_len)
    rec, _, run = serve_engine_run(torch, label, cfg, params, stream, max_len, arch_spec,
                                   counters, errors, stream_oracle, drain_s=SERVE_DRAIN_S,
                                   drop_first=lambda name: name.startswith("stream/"))
    records.append(rec)
    landed = {st.bp.fingerprint() for _, st in run.tuner.completed}
    rec, _, _ = serve_engine_run(torch, f"{label}, no tuner", cfg, params, stream, max_len,
                                 arch_spec, counters, errors, stream_oracle, tuner=False)
    records.append(rec)
    label = f"{label}, tuned DB"
    rec, eng, _ = serve_engine_run(torch, label, cfg, params, stream, max_len, arch_spec,
                                   counters, errors, stream_oracle, db=run.db, tuner=False)
    states = op_states(eng)
    recalled = [st for st in states if st.from_cache]
    evaluations = sum(st.cost_evaluations + st.prescreen_evaluations for st in states)
    missed = [st.bp["kernel"] for st in states
              if st.bp.fingerprint() in landed and not st.from_cache]
    kinds = sorted({st.bp["kernel"] for st in recalled})
    winners = {}
    for st in recalled:
        point = json.dumps(st.region.selected, sort_keys=True)
        winners.setdefault(st.bp["kernel"], {}).setdefault(point, 0)
        winners[st.bp["kernel"]][point] += 1
    print(f"[serve] {label}: {len(states)} classes, {len(recalled)} recalled from the drained "
          f"DB ({kinds}), {len(states) - len(recalled)} not in it (their default point); "
          f"{evaluations} evaluations of any kind (must be 0); recalled winners (classes a "
          f"point) {winners}")
    if (evaluations or missed or "flash_attention" not in kinds
            or not {"engine_prefill", "engine_decode"} & set(kinds)):
        errors.append(f"serve {label}: {evaluations} evaluations; landed but not recalled "
                      f"{missed}; recalled {kinds}")
    rec.update(classes_seen=len(states), recalled=len(recalled), recalled_kinds=kinds,
               evaluations=evaluations, winners=winners)
    records.append(rec)
    return records


def serve_engine_run(torch, label, cfg, params, reqs, max_len, arch_spec, counters, errors,
                     oracle, db=None, tuner=True, drain_s=0.0, drop_first=None) -> tuple:
    """One StreamingEngine run on the card on its own DB (or ``db``), with
    a BackgroundTuner unless ``tuner`` is False: the stats, each decode step
    beside its byte bound, the drain contract and the check against
    ``oracle`` (tokens, rows); returns (its record, the engine, the run)."""
    from repro_torch import models as tm
    from repro_torch.obs import Tracer
    from repro_torch.runtime import StreamingEngine

    with ServeRun(torch, label, counters, db=db, tuner=tuner) as run:
        eng = StreamingEngine(cfg, params, n_blocks=SERVE_BLOCKS, max_len=max_len,
                              tuning_db=run.db, background_tuner=run.tuner, tracer=Tracer())
        out = eng.serve(reqs)
    per_call = run.check(cfg, errors)
    rows = witness(engine_rows, run.logits.records, eng.tracer.events())
    if run.tuner is not None:
        landed = len(run.tuner.tuned_labels)
        info = run.stop_tuner(drain_s, drop_first)
        info["landed_in_run"] = landed
    else:
        info = {"tuner": None}
    s = eng.stats
    steps = engine_decode_steps(eng, reqs)
    bounds = [decode_step_bytes(tm, cfg, ctxs) / arch_spec.hbm_bandwidth * 1e3
              for _, _, ctxs in steps]
    n_rows = sum(n for _, n, _ in steps) / max(1, len(steps))
    step_ms = s.decode_s / max(1, s.decode_steps) * 1e3
    bound = sum(bounds) / max(1, len(bounds))
    line = (f"{len(out)} requests, {s.tokens_out} tokens, {s.tok_per_s:.1f} tok/s on the "
            f"virtual clock ({s.makespan_s:.3f} s), {s.tokens_out / run.wall_s:.1f} tok/s "
            f"wall; TTFT p50 {s.ttft_percentile(50) * 1e3:.3f} ms, p99 "
            f"{s.ttft_percentile(99) * 1e3:.3f} ms; prefill "
            f"{s.prefill_s / max(1, s.prefill_steps) * 1e3:.3f} ms a group "
            f"({s.prefill_steps} groups); decode {step_ms:.3f} ms a step at {n_rows:.2f} rows "
            f"(bound {bound:.3f} ms; {s.decode_steps} steps, peak in flight "
            f"{s.peak_in_flight})")
    bad = drained(eng, reqs)
    if bad or any(res.status != "ok" for res in eng.results.values()):
        errors.append(f"serve {label}: drain contract: {bad}, statuses "
                      f"{sorted({res.status for res in eng.results.values()})}")
    counts = serve_report(label, line, run, info, eng.traffic_classes_seen,
                          eng.hot_path_cost_evaluations, oracle[0], out, oracle[1], rows, errors)
    return ({"run": label, "requests": len(out), "tokens": s.tokens_out,
             "tok_per_s_virtual": s.tok_per_s, "wall_s": run.wall_s,
             "ttft_p50_ms": s.ttft_percentile(50) * 1e3,
             "ttft_p99_ms": s.ttft_percentile(99) * 1e3,
             "prefill_ms_per_group": s.prefill_s / max(1, s.prefill_steps) * 1e3,
             "decode_ms_per_step": step_ms, "decode_rows_per_step": n_rows,
             "decode_bound_ms": bound, "decode_steps": s.decode_steps,
             "step_ms": [round(ms, 4) for ms, _, _ in steps], "launches": run.launches,
             "trial_launches": run.trial_launches, "per_call": per_call, "tuner": info,
             "classes": eng.traffic_classes_seen,
             "tuned_scheduler_classes": eng.tuned_scheduler_classes, "oracle": counts},
            eng, run)


def serve_smoke(torch, device, counters, errors) -> dict:
    """Every arch at its SMOKE config through the engine on the card
    against the port's engine on the CPU, on the same tempered weights;
    then tinyllama's SMOKE config under chaos."""
    import copy

    from repro_torch import models as tm
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.data import adversarial_trace, bursty_open_loop_trace
    from repro_torch.obs import TickTimer, Tracer
    from repro_torch.runtime import ChaosInjector, StreamingEngine

    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=True)
        params = tm.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
        temper(torch, tm, params)
        reqs = bursty_open_loop_trace(cfg, 8, seed=SEED, scale=0.25)
        max_len = max(len(r.prompt) + r.max_new_tokens for r in reqs)
        with LogitsRecorder() as rec:
            ref_eng = StreamingEngine(cfg, params, n_blocks=4, max_len=max_len, tracer=Tracer())
            ref = ref_eng.serve(reqs)
        ref_rows = witness(engine_rows, rec.records, ref_eng.tracer.events())
        label = f"smoke {arch}"
        with ServeRun(torch, label, counters) as run:
            eng = StreamingEngine(cfg, copy.deepcopy(params).to(device), n_blocks=4,
                                  max_len=max_len, tuning_db=run.db,
                                  background_tuner=run.tuner, tracer=Tracer())
            got = eng.serve(reqs)
        run.check(cfg, errors)
        got_rows = witness(engine_rows, run.logits.records, eng.tracer.events())
        tuner = run.stop_tuner(0.0)
        print(f"[serve] {label}: card vs CPU engine, {sum(len(t) for t in got.values())} "
              f"tokens of {len(got)} requests; launches on the serving thread {run.launches}, "
              f"the tuner's trials {run.trial_launches}, plain {run.plain}; hot-path "
              f"evaluations {eng.hot_path_cost_evaluations}; background {tuner['tuned']} "
              f"classes, {tuner['dropped']} dropped")
        out[arch] = verdicts(label, ref, got, ref_rows, got_rows, errors, what="the CPU engine")
        bad = drained(eng, reqs)
        if bad or eng.hot_path_cost_evaluations:
            errors.append(f"serve {label}: drain contract: {bad}")

    # chaos: every request retires exactly once, the ok ones as the oracle says
    cfg = get_config("tinyllama-1.1b", smoke=True)
    params = tm.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    temper(torch, tm, params)
    max_len = 24
    reqs = adversarial_trace(cfg, 16, seed=SEED, scale=0.25, malformed_rate=0.2,
                             max_len_hint=max_len, deadline_ttl_s=0.03)

    on_card = copy.deepcopy(params).to(device)
    label = "chaos tinyllama-1.1b smoke"
    with ServeRun(torch, label, counters) as run:
        eng = StreamingEngine(cfg, on_card, n_blocks=4, max_len=max_len, queue_limit=4,
                              chaos=ChaosInjector(seed=SEED, **SERVE_CHAOS), timer=TickTimer(),
                              tuning_db=run.db, background_tuner=run.tuner, tracer=Tracer())
        got = eng.serve(reqs)
    got_rows = witness(engine_rows, run.logits.records, eng.tracer.events())
    run.stop_tuner(0.0)
    well = [r for r in reqs if r.rid in got]
    oracle, oracle_rows = serve_oracle(cfg, on_card, well, max_len)
    statuses = {}
    for res in eng.results.values():
        statuses[res.status] = statuses.get(res.status, 0) + 1
    bad = drained(eng, reqs)
    print(f"[serve] {label}: {len(reqs)} requests retired {statuses}; chaos "
          f"{eng.chaos.stats.as_metrics()}; drain contract {'held' if not bad else bad}; "
          f"launches on the serving thread {run.launches}, plain {run.plain}")
    counts = verdicts(label, oracle, got, oracle_rows, got_rows, errors)
    if bad:
        errors.append(f"serve {label}: drain contract: {bad}")
    if not eng.chaos.stats.faults:
        errors.append(f"serve {label}: the chaos never fired")
    out["chaos"] = {"statuses": statuses, "chaos": eng.chaos.stats.as_metrics(),
                    "oracle": counts}
    return out


def serve_phases(torch, device, arch_spec, counters, errors) -> dict:
    """The [serve] phases; returns their records.  Near-ties may part at
    most ``NEAR_TIE_SHARE`` of all the requests they compare."""
    from repro_torch.data import bursty_open_loop_trace

    records = serve_tinyllama(torch, device, arch_spec, counters, errors)
    for arch, depth in SERVE_ENGINES:
        cfg, params = serve_setup(torch, arch, depth, device)
        reqs = bursty_open_loop_trace(cfg, 8, seed=SEED, burst_size=4, burst_gap_s=0.05)
        max_len = max(len(r.prompt) + r.max_new_tokens for r in reqs)
        oracle = serve_oracle(cfg, params, reqs, max_len)
        rec, _, _ = serve_engine_run(torch, f"{arch} (depth {depth}) StreamingEngine", cfg,
                                     params, reqs, max_len, arch_spec, counters, errors, oracle)
        records.append(rec)
        del params
    smoke = serve_smoke(torch, device, counters, errors)
    tallies = [r["oracle"] for r in records] + [v.get("oracle", v) for v in smoke.values()]
    compared = sum(sum(t.values()) for t in tallies)
    near = sum(t["near-tie"] for t in tallies)
    print(f"[serve] near-ties: {near} of {compared} requests compared (at most "
          f"{NEAR_TIE_SHARE:.1%}), each within {NEAR_TIE_ULPS} bf16 ulps on both paths")
    if near > NEAR_TIE_SHARE * compared:
        errors.append(f"serve: {near} of {compared} requests part at near-ties")
    return {"runs": records, "smoke": smoke, "near_ties": near, "compared": compared}


# ---------------------------------------------------------------------------
# [kernel] flash backward, and the forward's lse
# ---------------------------------------------------------------------------

# tinyllama-1.1b's width at the [train] phase's S, at its B = 4 (the batch
# offsets of every pass) and at S = 2000 (a tail no tile divides),
# qwen3-0.6b's (16|8, hd 128), a C3 head dim (hd 36, padded to 40 by the
# wrapper) and recurrentgemma-2b's (10|1, hd 256: kv_split 1, 2, 5 and 10
# in bf16), which its [train] phase launches
FLASH_BWD = dict(B=1, S=4096, H=32, KV=4, hd=64)
FLASH_BWD_SHAPES = (FLASH_BWD, dict(FLASH_BWD, B=4), dict(FLASH_BWD, S=2000), FLASH_HD128,
                    dict(B=1, S=2048, H=8, KV=2, hd=36), FLASH_HD256)


def bwd_rows(outs) -> tuple:
    """(dq, dk, dv) as the checks read them: dq without query 0, whose exact
    gradient is zero (its one key is itself, so dP = delta there) and whose
    row error is a ratio of two roundings."""
    dq, dk, dv = outs
    return dq[:, 1:], dk, dv


def flash_bwd_bound_ms(arch, B, S, H, KV, hd, dtype_name) -> tuple:
    """(ms, what bounds it): five causal products of 2·S²·hd·H/2 flops a
    batch row at the bf16 tensor-core rate, or at a third of the TF32 rate
    in float32 (3xTF32); bytes: q, o, do, k, v and lse read, dq, dk, dv
    written, once each."""
    flops = 5 * 2.0 * B * H * S * S * hd / 2
    elt = 2 if dtype_name == "bfloat16" else 4
    ops = flops / arch.peak_flops if elt == 2 else 3 * flops / arch.peak_flops_tf32
    by_bytes = (elt * B * S * hd * (4 * H + 4 * KV) + 4 * B * H * S) / arch.hbm_bandwidth
    return max(ops, by_bytes) * 1e3, ("operations" if ops >= by_bytes else "bytes")


def by_batch_row(torch, fn, args) -> tuple:
    """``fn(*args)``'s outputs computed one batch row at a time and joined:
    the rows are independent, and the plain versions' S×S scores of one row
    are a quarter of those of B = 4."""
    rows = [fn(*(t[b:b + 1] for t in args)) for b in range(args[0].shape[0])]
    return tuple(torch.cat(parts) for parts in zip(*rows))


def flash_bwd_phase(torch, fa_mod, fa_ref, fa_ops, arch, timer, optin, errors) -> dict:
    """At each of FLASH_BWD_SHAPES, in bf16 and float32: the forward kernel
    with its lse (o equal to the call without it, lse against the plain
    version's), then every emitted point of ``flash_attention_bwd`` on that
    o and lse against ``attention_bwd_plain`` run on the same inputs in
    float32 (bf16) or float64 (float32), the plain versions a batch row at a
    time; returns {(dtype, B, S, hd): case}."""
    from repro_torch.core import bucket_pow2, pp_key

    device = torch.device("cuda:0")
    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    cases = {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        for shape in FLASH_BWD_SHAPES:
            B, S, H, KV, hd = (shape[k] for k in ("B", "S", "H", "KV", "hd"))
            tag = f"({B},{S},{H}|{KV},{hd})"
            q, k, v = fa_ref.make_inputs(gen, dtype=dtype, device=device, **shape)
            do = torch.randn(q.shape, generator=gen, device=device).to(dtype)
            # the forward at (64, 64), or where its tile hd has no such tile (f32
            # at hd 256), at the first emitted point
            fwd = dict(block_q=64, block_kv=64)
            if not fa_mod.launchable(hd, dtype_name, **fwd):
                fwd = next(iter(fa_ops.flash_region(S, hd, dtype_name, arch=arch,
                                                    heads=bucket_pow2(B * H)).space.points()))
            o, lse = fa_mod.flash_attention_cuda(q, k, v, **fwd, return_lse=True)
            same = torch.equal(o, fa_mod.flash_attention_cuda(q, k, v, **fwd))
            _, lse_ref = by_batch_row(
                torch, lambda *a: fa_ref.attention_ref(*a, return_lse=True), (q, k, v))
            err, row, failed = max_err(torch, (lse,), (lse_ref,), "float32")
            print(f"[kernel] flash {dtype_name} lse {tag} {fwd}: o equal to the call "
                  f"without lse {same}, lse max abs err {err:.3e} (tol {TOL['float32']}), "
                  f"row {row:.3e}")
            if failed or not same:
                errors.append(f"flash {dtype_name} lse {tag}: o equal {same}, err {err}, "
                              f"row {row}; failed {failed}")
            del lse_ref
            args = (q, k, v, o, lse, do)
            # bf16 against the plain version in float32; float32 against it in
            # float64, as the float32 plain version's own error (sums of up to
            # S·G terms) breaks the float32 element tolerance at S = 4096
            work = torch.float64 if dtype == torch.float32 else torch.float32
            ref = bwd_rows(by_batch_row(torch, fa_ref.attention_bwd_plain,
                                        tuple(t.to(work) for t in args)))
            if dtype == torch.float32:
                own = bwd_rows(by_batch_row(torch, fa_ref.attention_bwd_plain, args))
                err, row, failed = max_err(torch, own, ref, dtype_name)
                print(f"[kernel] flash bwd float32 {tag}: the float32 plain version against "
                      f"float64: max abs err {err:.3e}, row {row:.3e}, failed {failed}")
                del own
            region = fa_ops.flash_bwd_region(S, hd, dtype_name, arch=arch,
                                             heads=bucket_pow2(B * H), group=H // KV)
            hd_run = fa_mod.padded_hd(hd, dtype_name)
            for point in region.space.points():
                model = fa_mod.bwd_smem_bytes(point["block_q"], point["block_kv"], hd_run,
                                              q.element_size())
                native = fa_mod.bwd_smem_bytes_native(point["block_q"], point["block_kv"],
                                                      hd_run, dtype)
                if model != native or model > optin:
                    errors.append(f"flash bwd {point}: smem model {model}, kernel {native}, "
                                  f"limit {optin}")
                split = point.get("kv_split", 1)
                if split > 1:
                    model = fa_mod.bwd_scratch_bytes(B, S, KV, hd_run, split)
                    native = fa_mod.bwd_scratch_bytes_native(B, S, KV, hd_run, split)
                    if model != native:
                        errors.append(f"flash bwd {point}: scratch model {model}, kernel "
                                      f"{native}")
            err, row, times = sweep(
                torch, f"flash bwd {dtype_name} {tag}", region,
                lambda p, args=args: bwd_rows(fa_mod.flash_attention_bwd_cuda(*args, **p)),
                ref, dtype_name, timer, fa_mod.bwd_counter, errors)
            # no atomics: two calls of a point give the same bits, kv_split too
            differ = [p for p in region.space.points()
                      if not all(torch.equal(a, b) for a, b in zip(
                          fa_mod.flash_attention_bwd_cuda(*args, **p),
                          fa_mod.flash_attention_bwd_cuda(*args, **p)))]
            print(f"[kernel] flash bwd {dtype_name} {tag}: two calls of each of "
                  f"{len(times)} points bit-identical: {not differ}")
            for point in region.space.points():  # the hint's rank beside the card's
                hint = region.hints[pp_key(point)]
                print(f"[hint] flash bwd {dtype_name} {tag} {pp_key(point)}: est "
                      f"{hint['est_s'] * 1e3:.4f} ms (latency {hint['latency_s'] * 1e3:.4f}), "
                      f"measured {times[pp_key(point)]:.4f} ms")
            if differ:
                errors.append(f"flash bwd {dtype_name} {tag}: two calls differ at {differ}")
            cases[(dtype_name, B, S, hd)] = {"args": args, "ref": ref, "times": times,
                                          "err": err, "row": row, "shape": shape}
    return cases


def bwd_pass_ms(torch, runs, flush, reps: int = 10) -> dict:
    """Median ms of each pass of ``runs`` (name: launch), the passes run in
    order after one L2 flush, each between CUDA events."""
    times = {name: [] for name in runs}
    for _ in range(reps):
        flush()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(len(runs) + 1)]
        events[0].record()
        for i, launch in enumerate(runs.values()):
            launch()
            events[i + 1].record()
        events[-1].synchronize()
        for i, name in enumerate(runs):
            times[name].append(events[i].elapsed_time(events[i + 1]))
    return {name: sorted(t)[len(t) // 2] for name, t in times.items()}


def flash_bwd_main(torch, F, fa_mod, fa_ref, arch, timer, cases, db_path, errors) -> dict:
    """tinyllama's backward shape class of each dtype, and bf16's at the
    train step's B=4, through the registry (a cold tune, then a fresh op
    recalling with 0 evaluations through the fast path), and its tuned
    point's time beside the bound, the plain version's and SDPA's backward
    (forward + backward less forward); in bf16 also each pass's time at the
    tuned point (``[kernel] flash bwd passes``)."""
    from repro_torch.core.cost import l2_flush

    flush = l2_flush(torch.device("cuda:0"), 2 * arch.l2_bytes)
    out = {}
    for dtype_name, B in (("bfloat16", 1), ("bfloat16", 4), ("float32", 1)):
        case = cases[(dtype_name, B, FLASH_BWD["S"], FLASH_BWD["hd"])]
        args = case["args"]
        fa_mod.bwd_counter.reset()
        state, tune_s, recall_s = main_path(torch, "flash_attention_bwd", args, case["ref"],
                                            dtype_name, db_path, errors, view=bwd_rows)
        point = state.region.selected
        q, k, v, o, lse, do = args
        qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

        sdpa_ms = timer.ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot)) - timer.ms(sdpa)
        shape = dict(FLASH_BWD, B=B)
        bound, by = flash_bwd_bound_ms(arch, dtype_name=dtype_name, **shape)
        ms = timer.ms(lambda: fa_mod.flash_attention_bwd_cuda(*args, **point))
        plain_ms = timer.ms(lambda: by_batch_row(torch, fa_ref.attention_bwd_plain, args), reps=3)
        best = min(case["times"], key=case["times"].get)
        row = {
            "tuned_point": point, "ms": ms, "bound_ms": bound, "bound_by": by,
            "plain_ms": plain_ms, "sdpa_bwd_ms": sdpa_ms, "tune_s": tune_s,
            "recall_s": recall_s, "candidates": len(case["times"]),
            "fastest_swept_point": json.loads(best), "fastest_swept_ms": case["times"][best],
            "registry_launches": fa_mod.bwd_counter.launches,
        }
        tag = f"({B},{shape['S']},{shape['H']}|{shape['KV']},{shape['hd']})"
        print(f"[kernel] flash bwd {dtype_name} {tag} tuned {point}: {ms:.4f} ms, "
              f"bound {bound:.4f} ms ({by}), plain {plain_ms:.3f} ms, SDPA backward "
              f"{sdpa_ms:.4f} ms")
        if dtype_name == "bfloat16":
            row["passes_ms"] = bwd_pass_ms(torch, fa_mod.bwd_pass_runs(*args, **point), flush)
            row["scratch_bytes"] = fa_mod.bwd_scratch_bytes(
                B, shape["S"], shape["KV"], shape["hd"], point.get("kv_split", 1))
            print(f"[kernel] flash bwd passes {tag} at {point}: " + ", ".join(
                f"{name} {t:.4f} ms" for name, t in row["passes_ms"].items())
                + f" (sum {sum(row['passes_ms'].values()):.4f}); SDPA backward {sdpa_ms:.4f} ms; "
                f"kv_split scratch {row['scratch_bytes'] / 1e6:.1f} MB")
        out[dtype_name if B == 1 else f"{dtype_name}_b{B}"] = row
    for key, row in out.items():
        d = key.split("_")[0]
        row["max_row_err"] = max(c["row"] for k, c in cases.items() if k[0] == d)
        row["max_abs_err"] = max(c["err"] for k, c in cases.items() if k[0] == d)
    # recurrentgemma-2b's hd 256 (bf16 on the wgmma kernel, float32 on
    # mma.sync): its class tuned through the registry, the tuned point beside
    # the fastest swept one, SDPA's backward and the bound; bf16's passes
    from repro_torch.core import pp_key

    for dtype_name in ("bfloat16", "float32"):
        case = cases[(dtype_name, FLASH_HD256["B"], FLASH_HD256["S"], FLASH_HD256["hd"])]
        args = case["args"]
        q, k, v, o, lse, do = args
        qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

        sdpa_ms = timer.ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot)) - timer.ms(sdpa)
        fa_mod.bwd_counter.reset()
        state, tune_s, recall_s = main_path(torch, "flash_attention_bwd", args, case["ref"],
                                            dtype_name, db_path, errors, view=bwd_rows)
        point = state.region.selected
        best = min(case["times"], key=case["times"].get)
        bound, by = flash_bwd_bound_ms(arch, dtype_name=dtype_name, **FLASH_HD256)
        plain_ms = timer.ms(lambda: by_batch_row(torch, fa_ref.attention_bwd_plain, args), reps=3)
        ms = timer.ms(lambda: fa_mod.flash_attention_bwd_cuda(*args, **point))
        swept = case["times"][pp_key(point)]
        tag = "(1,2048,10|1,256)"
        print(f"[kernel] flash bwd {dtype_name} {tag} tuned {point}: {ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by}), {ms / bound:.2f}x; plain {plain_ms:.3f} ms, SDPA "
              f"backward {sdpa_ms:.4f} ms ({ms / sdpa_ms:.2f}x); fastest swept {best} "
              f"{case['times'][best]:.4f} ms, the tuned point {swept:.4f} ms in the sweep, "
              f"within 10%: {swept <= 1.1 * case['times'][best]}")
        row = {
            "tuned_point": point, "ms": ms, "bound_ms": bound, "bound_by": by,
            "plain_ms": plain_ms, "sdpa_bwd_ms": sdpa_ms, "tune_s": tune_s,
            "recall_s": recall_s, "candidates": len(case["times"]),
            "fastest_swept_point": json.loads(best), "fastest_swept_ms": case["times"][best],
            "max_abs_err": case["err"], "max_row_err": case["row"]}
        if dtype_name == "bfloat16":
            row["passes_ms"] = bwd_pass_ms(torch, fa_mod.bwd_pass_runs(*args, **point), flush)
            print(f"[kernel] flash bwd passes {tag} at {point}: " + ", ".join(
                f"{name} {t:.4f} ms" for name, t in row["passes_ms"].items())
                + f" (sum {sum(row['passes_ms'].values()):.4f}); SDPA backward {sdpa_ms:.4f} ms")
        out[f"{dtype_name}_hd256"] = row
    return out


# ---------------------------------------------------------------------------
# [train]: the training slice (repro_torch.runtime.train) on the card
# ---------------------------------------------------------------------------

TRAIN = dict(arch="tinyllama-1.1b", B=4, S=4096, steps=20, micro=(1, 2, 4),
             remat=("none", "full"), overfit=10)
TRAIN_GRADS = dict(layers=2, B=1, S=2048)
# the scans' families at full width in the gradient check: falcon-mamba-7b at
# 2 of 64 layers, recurrentgemma-2b at 3 of 26 (one (rec, rec, attn) group)
TRAIN_GRADS_SCANS = (("falcon-mamba-7b", 2), ("recurrentgemma-2b", 3))
TRAIN_RESTART = dict(layers=2, B=2, S=1024, steps=8, save_every=2, fail_at=5)
# the restart drill on the hybrid family: recurrentgemma-2b at 3 layers.  A
# checkpoint of it holds 0.86 B parameters and their moments (8.6 GB, the
# 256000 x 2560 embedding most of it), so it saves twice (at step 4 and at
# the end): ~17 GB of checkpoint writes.  In both drills the uninterrupted
# reference saves none: the drill compares losses
TRAIN_RESTART_HYBRID = dict(TRAIN_RESTART, arch="recurrentgemma-2b", layers=3, steps=6,
                            save_every=4, fail_at=5)
# the scans' families through the Trainer at remat none, bf16 parameters and
# float32 AdamW moments: recurrentgemma-2b uncut (26 layers, 2.9 B params);
# falcon-mamba-7b at full width, 8 of 64 layers (7.27 B params uncut take
# ~101 GB with float32 gradients and moments; 8 layers ~1.37 B, ~19 GB)
TRAIN_SCANS = (dict(arch="recurrentgemma-2b", layers=None, B=1, S=2048),
               dict(arch="falcon-mamba-7b", layers=8, B=2, S=2048))
TRAIN_SCAN_STEPS = 10
TRAIN_SCAN_OVERFIT = 6
# the worst gradient leaf's ||g - r|| / ||r||, kernel route against plain versions
GRAD_TOL = {"float32": 1e-3, "bfloat16": 3e-2}
# train SMOKE card vs CPU: the loss's relative error, and each leaf's update
# ||Δcard - Δcpu|| / ||Δcpu|| (as tests/test_torch_train_step.py).  Every
# gradient of Whisper runs through its bf16 encoder (the decoder reads it
# through cross-attention), so it has bf16 precision, and AdamW's first
# step, about lr·sign(g), flips where g is within that noise: on the card
# 8.6e-2 at worst in the encoder, 3.1e-2 in the decoder's cross-attention
# wk, 1.9e-2 in its embedding; the float32 archs 7e-5..1.4e-4.  A wrong
# gradient gives 1 or more (1 if zero, 2 if its sign is flipped)
SMOKE_LOSS_TOL, SMOKE_UPDATE_TOL, SMOKE_BF16_UPDATE_TOL = 1e-4, 2e-2, 0.25
TRAIN_SMOKE = ("tinyllama-1.1b", "granite-moe-1b-a400m", "qwen2-vl-2b", "whisper-large-v3",
               "falcon-mamba-7b", "recurrentgemma-2b")


def leaf_names(tree, prefix: str = "") -> list:
    """The leaves' paths in flatten order (dict keys sorted, lists by index)."""
    if isinstance(tree, dict):
        return [n for key in sorted(tree) for n in leaf_names(tree[key], f"{prefix}/{key}")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}/{i}")]
    return [prefix.lstrip("/")]


def flash_counts(fa_mod) -> tuple:
    return (fa_mod.counter.launches, fa_mod.bwd_counter.launches,
            fa_mod.counter.plain_calls + fa_mod.bwd_counter.plain_calls)


def train_counters() -> dict:
    """{kernel: (forward counter, backward counter)} of the kernels a train
    step reaches."""
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.kernels.rglru_scan import rglru_scan as rg_mod
    from repro_torch.kernels.ssm_scan import ssm_scan as ssm_mod

    return {"flash_attention": (fa_mod.counter, fa_mod.bwd_counter),
            "ssm_scan": (ssm_mod.counter, ssm_mod.bwd_counter),
            "rglru_scan": (rg_mod.counter, rg_mod.bwd_counter)}


def reset_train_counts() -> None:
    for pair in train_counters().values():
        for counter in pair:
            counter.reset()


def train_counts() -> tuple:
    """({kernel: (forward launches, backward launches)} of the kernels that
    launched, plain calls of any of them)."""
    counts = {name: (f.launches, b.launches) for name, (f, b) in train_counters().items()
              if f.launches or b.launches}
    plain = sum(c.plain_calls for pair in train_counters().values() for c in pair)
    return counts, plain


def step_launches(cfg, remat: str, n_micro: int = 1) -> dict:
    """{kernel: (forward, backward) launches of one train step}: one of each
    a layer that calls the kernel and microbatch, the forward twice where
    remat recomputes it (``full``, and ``dots``, which sees each kernel's
    autograd Function as one op to recompute)."""
    if cfg.family == "ssm":
        layers = {"ssm_scan": cfg.n_layers}
    elif cfg.family == "hybrid":
        kinds = [cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.n_layers)]
        layers = {"rglru_scan": kinds.count("rec"), "flash_attention": kinds.count("attn")}
    else:
        layers = {"flash_attention": cfg.n_layers}
    again = 2 if remat in ("full", "dots") else 1
    return {name: (n * n_micro * again, n * n_micro) for name, n in layers.items() if n}


def train_grads(torch, device, errors, archs=((TRAIN["arch"], TRAIN_GRADS["layers"]),)) -> dict:
    """Each of ``archs`` (arch, layers) at full width, B=1, S=2048, wq and
    wk tempered: the loss and every gradient leaf on the kernel route
    against the same under ``plain_versions()``, float32 then bf16
    parameters, under remat ``full`` and ``dots`` (selective checkpointing,
    which sees each kernel's autograd Function, ``FlashAttentionFn``,
    ``SelectiveScanFn``, ``LruScanFn``, as one op: its forward runs again in
    the recompute, and what it saves must reach the backward); each
    kernel's launches exact (:func:`step_launches`) and no plain call."""
    from repro_torch import models as tm
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.runtime.train import _loss_and_grads, batch_tensors
    from repro_torch.tree import as_tree, flatten, tree_map

    out = {}
    for arch, layers in archs:
        cfg = get_config(arch).with_(n_layers=layers)
        params = tm.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
        temper(torch, tm, params)
        base = as_tree(params)
        del params
        batch = batch_tensors(SyntheticLMDataset(cfg, TRAIN_GRADS["B"], TRAIN_GRADS["S"],
                                                 seed=SEED).batch(0), device)
        refs = {}
        for dtype_name, remat in itertools.product(("float32", "bfloat16"), ("full", "dots")):
            cfg = cfg.with_(remat=remat)
            tree = tree_map(lambda t: t.to(getattr(torch, dtype_name)), base)
            leaves, structure = flatten(tree)
            names = leaf_names(tree)
            _loss_and_grads(leaves, structure, batch, cfg)  # the kernel classes resolved first
            reset_train_counts()
            loss, grads = _loss_and_grads(leaves, structure, batch, cfg)
            torch.cuda.synchronize()
            counts, plain = train_counts()
            if dtype_name not in refs:  # remat changes no value: one plain run a dtype
                with tm.plain_versions():
                    refs[dtype_name] = _loss_and_grads(leaves, structure, batch, cfg)
            ref_loss, ref = refs[dtype_name]
            rel = [(float((g.float() - r.float()).norm() / r.float().norm().clamp_min(1e-30)), n)
                   for g, r, n in zip(grads, ref, names)]
            worst, name = max(rel)
            loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
            want = step_launches(cfg, remat)
            print(f"[train] grads {arch} {dtype_name} params ({layers} layers, remat {remat}): "
                  f"loss {float(loss):.6f} vs plain {float(ref_loss):.6f} (rel {loss_rel:.2e}); "
                  f"worst leaf {name} {worst:.3e} (tol {GRAD_TOL[dtype_name]}); launches "
                  f"(forward, backward) {counts} (expect {want}), plain calls on the kernel "
                  f"route {plain}")
            key = f"{dtype_name} {remat}" if arch == TRAIN["arch"] else f"{arch} {dtype_name} {remat}"
            out[key] = {"loss": float(loss), "plain_loss": float(ref_loss), "worst_leaf": name,
                        "worst_leaf_rel": worst, "launches": counts}
            if arch == TRAIN["arch"]:
                out[key].update(flash_launches=counts["flash_attention"][0],
                                flash_bwd_launches=counts["flash_attention"][1])
            if (worst > GRAD_TOL[dtype_name] or loss_rel > GRAD_TOL[dtype_name]
                    or counts != want or plain):
                errors.append(f"train grads {arch} {dtype_name} {remat}: worst leaf {name} "
                              f"{worst}, loss {loss_rel}, launches {counts} (expect {want}), "
                              f"plain {plain}")
            del grads, ref, tree, leaves
            if remat == "dots":
                del refs[dtype_name]
            torch.cuda.empty_cache()
    return out


def train_tinyllama(torch, device, arch_spec, errors) -> dict:
    """tinyllama-1.1b uncut (bf16 parameters, float32 AdamW moments) on
    ``SyntheticLMDataset(seed 0)`` at B=4, S=4096: ``Trainer.joint_tune``
    over micro x remat, each of its measured steps read through its
    ``trial`` hook (peak memory, exact flash launches), 20 steps at the
    winner with the counts reset before and read after, then a second
    Trainer on the same DB recalling the winner and every kernel class with
    0 evaluations, and the winner's step overfitting the first batch from
    tempered weights (its loss must fall)."""
    import contextlib
    import dataclasses
    import os

    from repro_torch import models as tm
    from repro_torch.configs import get_config
    from repro_torch.core import TuningDB
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.models import analytic_step_flops, serving
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import Trainer, TrainLoopConfig
    from repro_torch.runtime.train import batch_tensors, make_train_step
    from repro_torch.tree import as_tree

    cfg = get_config(TRAIN["arch"])
    B, S, steps = TRAIN["B"], TRAIN["S"], TRAIN["steps"]
    opt = AdamWConfig(warmup_steps=4, total_steps=steps)
    loop = TrainLoopConfig(total_steps=steps, n_microbatches=1,
                           microbatch_candidates=TRAIN["micro"], remat_candidates=TRAIN["remat"],
                           joint_tune=True, joint_cap=16, seed=SEED)
    ds = SyntheticLMDataset(cfg, B, S, seed=SEED)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    db_path = os.path.join(tmp, "train_db.json")
    trainer = Trainer(cfg, opt, loop, tuning_db=TuningDB(db_path), device=device)
    params, state = trainer.init_state()
    trials = {}

    @contextlib.contextmanager
    def trial(n, remat):
        """One measured step of the joint search: its time and peak memory
        (the least and the most of its runs) and its flash launches, which
        must be exact in each run."""
        for counter in (fa_mod.counter, fa_mod.bwd_counter):
            counter.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        fwd, bwd, plain = flash_counts(fa_mod)
        want = (cfg.n_layers * n * (2 if remat == "full" else 1), cfg.n_layers * n)
        row = trials.setdefault((n, remat), {"micro": n, "remat": remat, "runs": 0,
                                             "ms": ms, "peak_gb": 0.0, "flash_launches": fwd,
                                             "flash_bwd_launches": bwd})
        row["runs"] += 1
        row["ms"] = min(row["ms"], ms)
        row["peak_gb"] = max(row["peak_gb"], torch.cuda.max_memory_allocated() / 1e9)
        if (fwd, bwd) != want or plain:
            errors.append(f"train micro {n} remat {remat}: launches {fwd}/{bwd}, "
                          f"expected {want}, plain {plain}")

    t0 = time.perf_counter()
    joint = trainer.joint_tune(ds, state=(params, state), trial=trial)
    joint_s = time.perf_counter() - t0
    print(f"[train] {cfg.name} B={B} S={S}: joint tune over micro {TRAIN['micro']} x remat "
          f"{TRAIN['remat']}: winner {joint.assignment}, {joint.evaluations} step "
          f"evaluations, {joint_s:.1f} s")
    if joint.from_cache or joint.evaluations <= 0:
        errors.append("train: the joint tune measured nothing")
    assignments = []
    for n, remat in itertools.product(TRAIN["micro"], TRAIN["remat"]):
        row = trials.get((n, remat))
        if row is None:
            errors.append(f"train micro {n} remat {remat}: the joint search never ran it")
            continue
        assignments.append(row)
        print(f"[train] {cfg.name} micro {n} remat {remat}: {row['runs']} measured steps, "
              f"fastest {row['ms']:.1f} ms, peak memory {row['peak_gb']:.2f} GB, flash "
              f"forward {row['flash_launches']}, "
              f"backward {row['flash_bwd_launches']} a step (exact in every run)")
    del params, state
    torch.cuda.empty_cache()

    n = trainer.region.selected["n_micro"]
    for counter in (fa_mod.counter, fa_mod.bwd_counter):
        counter.reset()
    hist = trainer.run(ds)
    torch.cuda.synchronize()
    fwd, bwd, plain = flash_counts(fa_mod)
    step_ms = sorted(hist["step_time"][1:])[len(hist["step_time"][1:]) // 2] * 1e3
    bound_ms = analytic_step_flops(cfg, "train", B, S) / arch_spec.peak_flops * 1e3
    per = (cfg.n_layers * n * (2 if trainer._step_remat == "full" else 1), cfg.n_layers * n)
    classes = [{"kernel": st.bp["kernel"], "seq": st.bp["seq"], "heads": st.bp["heads"],
                "dtype": st.bp["dtype"], "point": st.region.selected,
                "evaluations": st.cost_evaluations}
               for st in trainer.rule.states().values()]
    loss0, loss_last = hist["loss"][0], hist["loss"][-1]
    print(f"[train] {cfg.name} B={B} S={S} at the winner (micro {n}, remat "
          f"{trainer._step_remat}): {len(hist['loss'])} steps, step {step_ms:.1f} ms (median "
          f"after the first) against a bound of {bound_ms:.1f} ms (analytic_step_flops at the "
          f"bf16 peak), MFU {bound_ms / step_ms:.3f}, {B * S / step_ms * 1e3:.0f} tokens/s; "
          f"loss {loss0:.4f} at step 0, {loss_last:.4f} at step {steps - 1}")
    print(f"[train] {cfg.name} launches over the run: flash forward {fwd} ({fwd / steps:.0f} a "
          f"step, expect {per[0]}), backward {bwd} ({bwd / steps:.0f} a step, expect "
          f"{per[1]}), plain calls {plain}")
    for c in classes:
        print(f"[train] kernel class {c['kernel']} seq {c['seq']} heads {c['heads']} "
              f"{c['dtype']}: point {c['point']}, {c['evaluations']} evaluations")
    if not all(math.isfinite(x) for x in hist["loss"]):
        errors.append(f"train: a loss is not finite: {hist['loss']}")
    if (fwd, bwd) != (per[0] * steps, per[1] * steps) or plain:
        errors.append(f"train: launches {fwd}/{bwd} over {steps} steps, expected {per}, "
                      f"plain {plain}")
    trainer._final_params = None
    torch.cuda.empty_cache()

    # a second Trainer on the same DB recalls the joint winner and every kernel
    # class.  Then it overfits the stream's first batch from tempered weights
    # (its loss must fall): the stream itself is not learnt in 20 steps (a
    # random walk inside a band of the vocabulary), nor, under the JAX init's
    # chaotic attention (ROADMAP §C), is one batch
    trainer2 = Trainer(cfg, opt, dataclasses.replace(loop, total_steps=1),
                       tuning_db=TuningDB(db_path), device=device)
    trainer2.run(ds)
    trainer2._final_params = None
    tempered = tm.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    temper(torch, tm, tempered)
    params = as_tree(tempered)
    state = adamw_init(params, opt)
    del tempered
    step = make_train_step(cfg.with_(remat=trainer2._step_remat), opt,
                           trainer2.region.selected["n_micro"])
    batch0, fit = batch_tensors(ds.batch(0), device), []
    with serving(trainer2.rule):
        for _ in range(TRAIN["overfit"]):
            params, state, metrics = step(params, state, batch0)
            fit.append(float(metrics["loss"]))
        # one more step at the winner, profiled (its result is dropped)
        t1 = time.perf_counter()
        prof = step_profile(torch, lambda: step(params, state, batch0))
        prof["host_ms"] = (time.perf_counter() - t1) * 1e3
    dev_ms = prof["device_ms"]
    print(f"[train] profiled step at the winner: {dev_ms:.1f} ms of device time in a "
          f"{prof['host_ms']:.1f} ms profiled step; " + ", ".join(
              f"{kind} {ms:.1f} ms ({ms / dev_ms:.1%})" for kind, ms in prof["by_kind_ms"].items()))
    for key, ms in prof["top"]:
        print(f"[train]   {ms:9.3f} ms  {key}")
    del params, state, batch0
    recalled = trainer2.joint_result
    evals2 = sum(st.cost_evaluations for st in trainer2.rule.states().values())
    print(f"[train] second Trainer on the same DB: joint winner {recalled.assignment} "
          f"from_cache={recalled.from_cache}, {recalled.evaluations} evaluations; "
          f"{len(trainer2.rule.states())} kernel classes, {evals2} evaluations; overfitting "
          f"one batch from tempered weights, loss {fit[0]:.4f} at step 0, {fit[-1]:.4f} at "
          f"step {len(fit) - 1}")
    if (not recalled.from_cache or recalled.evaluations or evals2
            or recalled.assignment != joint.assignment):
        errors.append("train: the second Trainer did not recall everything with 0 evaluations")
    if not fit[-1] < fit[0] or not all(math.isfinite(x) for x in fit):
        errors.append(f"train: the loss did not fall on one batch ({fit})")
    trainer2._final_params = None
    torch.cuda.empty_cache()
    return {
        "arch": cfg.name, "B": B, "S": S, "joint": joint.assignment,
        "joint_evaluations": joint.evaluations, "joint_s": joint_s,
        "assignments": assignments, "steps": len(hist["loss"]), "step_ms": step_ms,
        "step_times_ms": [x * 1e3 for x in hist["step_time"]], "bound_ms": bound_ms,
        "mfu": bound_ms / step_ms, "tokens_per_s": B * S / step_ms * 1e3,
        "loss_first": loss0, "loss_last": loss_last, "overfit_losses": fit,
        "flash_launches": fwd,
        "flash_bwd_launches": bwd, "kernel_classes": classes,
        "recall_evaluations": recalled.evaluations + evals2, "step_profile": prof,
    }


def train_scan_model(torch, device, arch_spec, errors, arch, layers, B, S) -> dict:
    """``arch`` at full width (``layers`` of its layers, or uncut), bf16
    parameters and float32 AdamW moments, remat none, on
    ``SyntheticLMDataset(seed 0)`` through the ``Trainer``: one warm step
    (the kernel classes tuned inline), then TRAIN_SCAN_STEPS steps with the
    counts set to 0 just before and read just after (each kernel's forward
    and backward launches exact, :func:`step_launches`, and no plain call),
    the step's time beside ``analytic_step_flops`` at the bf16 peak, its
    peak memory and one profiled step; a second Trainer on the same DB
    recalling every kernel class with 0 evaluations; and the step
    overfitting the first batch from tempered weights (its loss must
    fall)."""
    import dataclasses
    import os

    from repro_torch import models as tm
    from repro_torch.configs import get_config
    from repro_torch.core import TuningDB
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import analytic_param_count, analytic_step_flops, serving
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import Trainer, TrainLoopConfig
    from repro_torch.runtime.train import batch_tensors, make_train_step
    from repro_torch.tree import as_tree

    cfg = get_config(arch)
    cfg = (cfg.with_(n_layers=layers) if layers else cfg).with_(remat="none")
    steps = TRAIN_SCAN_STEPS
    opt = AdamWConfig(warmup_steps=2, total_steps=steps)
    loop = TrainLoopConfig(total_steps=steps, n_microbatches=1, microbatch_candidates=(1,),
                           seed=SEED)
    ds = SyntheticLMDataset(cfg, B, S, seed=SEED)
    db_path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_train_scan_"), "train_db.json")
    label = f"{cfg.name} ({cfg.n_layers} layers) B={B} S={S}"
    trainer = Trainer(cfg, opt, loop, tuning_db=TuningDB(db_path), device=device)
    params, state = trainer.init_state()
    t0 = time.perf_counter()
    trainer.warm(params, state, batch_tensors(ds.batch(0), device))
    warm_s = time.perf_counter() - t0
    del params, state
    torch.cuda.empty_cache()
    reset_train_counts()
    torch.cuda.reset_peak_memory_stats()
    hist = trainer.run(ds)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts, plain = train_counts()
    step_ms = sorted(hist["step_time"][1:])[len(hist["step_time"][1:]) // 2] * 1e3
    bound_ms = analytic_step_flops(cfg, "train", B, S) / arch_spec.peak_flops * 1e3
    per = step_launches(cfg, "none")
    want = {name: (f * steps, b * steps) for name, (f, b) in per.items()}
    classes = [{"kernel": st.bp["kernel"], "dtype": st.bp["dtype"], "point": st.region.selected,
                "evaluations": st.cost_evaluations}
               for st in trainer.rule.states().values()]
    loss0, loss_last = hist["loss"][0], hist["loss"][-1]
    print(f"[train] {label}: {analytic_param_count(cfg) / 1e9:.3f} B params; warm step (the "
          f"kernel classes tuned inline) {warm_s:.1f} s; {len(hist['loss'])} steps, step "
          f"{step_ms:.1f} ms (median after the first) against a bound of {bound_ms:.1f} ms "
          f"(analytic_step_flops at the bf16 peak), MFU {bound_ms / step_ms:.3f}, "
          f"{B * S / step_ms * 1e3:.0f} tokens/s, peak memory {peak_gb:.2f} GB; loss "
          f"{loss0:.4f} at step 0, {loss_last:.4f} at step {steps - 1}")
    print(f"[train] {label} launches over the run (forward, backward): {counts}, expect "
          f"{want} ({per} a step); plain calls {plain}")
    for c in classes:
        print(f"[train] {cfg.name} kernel class {c['kernel']} {c['dtype']}: point {c['point']}, "
              f"{c['evaluations']} evaluations")
    if not all(math.isfinite(x) for x in hist["loss"]):
        errors.append(f"train {label}: a loss is not finite: {hist['loss']}")
    if counts != want or plain:
        errors.append(f"train {label}: launches {counts}, expected {want}, plain {plain}")
    trainer._final_params = None
    torch.cuda.empty_cache()

    # a second Trainer on the same DB recalls every kernel class
    trainer2 = Trainer(cfg, opt, dataclasses.replace(loop, total_steps=1),
                       tuning_db=TuningDB(db_path), device=device)
    trainer2.run(ds)
    trainer2._final_params = None
    torch.cuda.empty_cache()
    evals2 = sum(st.cost_evaluations for st in trainer2.rule.states().values())
    recalled = len(trainer2.rule.states())
    # the step overfitting one batch from tempered weights, then one step
    # profiled (its result dropped)
    tempered = tm.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    temper(torch, tm, tempered)
    params = as_tree(tempered)
    del tempered
    state = adamw_init(params, opt)
    step = make_train_step(cfg, opt, 1)
    batch0, fit = batch_tensors(ds.batch(0), device), []
    with serving(trainer2.rule):
        for _ in range(TRAIN_SCAN_OVERFIT):
            params, state, metrics = step(params, state, batch0)
            fit.append(float(metrics["loss"]))
        prof = step_profile(torch, lambda: step(params, state, batch0))
    dev_ms = prof["device_ms"]
    print(f"[train] {label} profiled step: {dev_ms:.1f} ms of device time; " + ", ".join(
        f"{kind} {ms:.1f} ms ({ms / dev_ms:.1%})" for kind, ms in prof["by_kind_ms"].items()))
    for key, ms in prof["top"]:
        print(f"[train]   {ms:9.3f} ms  {key}")
    print(f"[train] {label} second Trainer on the same DB: {recalled} kernel classes, {evals2} "
          f"evaluations; overfitting one batch from tempered weights, loss {fit[0]:.4f} at step "
          f"0, {fit[-1]:.4f} at step {len(fit) - 1}")
    if evals2 or recalled != len(classes):
        errors.append(f"train {label}: the second Trainer recalled {recalled} of "
                      f"{len(classes)} classes with {evals2} evaluations")
    if not fit[-1] < fit[0] or not all(math.isfinite(x) for x in fit):
        errors.append(f"train {label}: the loss did not fall on one batch ({fit})")
    del params, state, batch0
    torch.cuda.empty_cache()
    return {
        "arch": cfg.name, "layers": cfg.n_layers, "B": B, "S": S, "remat": "none",
        "params_b": analytic_param_count(cfg) / 1e9, "warm_s": warm_s,
        "steps": len(hist["loss"]), "step_ms": step_ms,
        "step_times_ms": [x * 1e3 for x in hist["step_time"]], "bound_ms": bound_ms,
        "mfu": bound_ms / step_ms, "tokens_per_s": B * S / step_ms * 1e3, "peak_gb": peak_gb,
        "loss_first": loss0, "loss_last": loss_last, "overfit_losses": fit,
        "launches": counts, "launches_a_step": per, "kernel_classes": classes,
        "recall_evaluations": evals2, "recalled_classes": recalled, "step_profile": prof,
    }


def train_restart(torch, device, errors, r=TRAIN_RESTART) -> dict:
    """``r["arch"]`` (tinyllama-1.1b by default) at full width, 2 layers,
    B=2, S=1024, 8 steps saving every 2 (recurrentgemma-2b: 3 layers, 6
    steps saving every 4), a SimulatedFailure before step 5: one restart,
    resumed from the step-4 checkpoint, losses equal bit for bit to an
    uninterrupted run's (both on one TuningDB, so both run the same kernel
    points)."""
    import os

    from repro_torch.configs import get_config
    from repro_torch.core import TuningDB
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import SimulatedFailure, Trainer, TrainLoopConfig

    cfg = get_config(r.get("arch", TRAIN["arch"])).with_(n_layers=r["layers"])
    opt = AdamWConfig(warmup_steps=2, total_steps=r["steps"])
    ds = SyntheticLMDataset(cfg, r["B"], r["S"], seed=SEED)
    db = TuningDB()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_restart_")

    ref = Trainer(cfg, opt, TrainLoopConfig(total_steps=r["steps"], seed=SEED), tuning_db=db,
                  device=device).run(ds)
    fired = []

    def hook(step):
        if step == r["fail_at"] and not fired:
            fired.append(step)
            raise SimulatedFailure("node lost")

    ft_loop = TrainLoopConfig(total_steps=r["steps"], save_every=r["save_every"],
                              ckpt_dir=os.path.join(tmp, "ft"), seed=SEED)
    trainer = Trainer(cfg, opt, ft_loop, tuning_db=db, device=device)
    hist = trainer.run(ds, failure_hook=hook)
    resumed = r["fail_at"] - r["fail_at"] % r["save_every"]
    want_steps = list(range(r["fail_at"])) + list(range(resumed, r["steps"]))
    want_loss = ref["loss"][:r["fail_at"]] + ref["loss"][resumed:]
    same = hist["loss"] == want_loss
    print(f"[train] restart {cfg.name} ({r['layers']} layers): {trainer.restarts} restart(s), "
          f"steps {hist['step']}, resumed from "
          f"step {resumed}; losses bit-identical to the uninterrupted run's: {same} "
          f"(last {hist['loss'][-1]!r} vs {ref['loss'][-1]!r})")
    if trainer.restarts != 1 or hist["step"] != want_steps or not same:
        errors.append(f"train restart {cfg.name}: restarts {trainer.restarts}, steps {hist['step']}, "
                      f"losses {hist['loss']} vs {want_loss}")
    return {"restarts": trainer.restarts, "steps": hist["step"], "bit_identical": same,
            "losses": hist["loss"], "reference_losses": ref["loss"]}


def train_smoke(torch, device, errors) -> dict:
    """One ``make_train_step`` of each trainable family's SMOKE config on the
    card against the same step on the CPU, tempered weights in float32 (the
    float32 kernels on the card) but Whisper's encoder layers, which stay
    bf16 as the JAX model keeps them (ROADMAP §C): the loss within
    SMOKE_LOSS_TOL; each leaf's update p − p₀ within SMOKE_UPDATE_TOL of the
    CPU's in norm (as ``tests/test_torch_train_step.py`` holds the port's
    against JAX's: one AdamW step moves an element by about lr, so a wrong
    gradient shows in the update, not in the parameter), SMOKE_BF16_UPDATE_TOL
    in Whisper, whose gradients all run through its bf16 encoder, and that
    encoder's bf16 leaves' worst row within 4·2⁻⁸.  The SSM and hybrid
    families run their scans' backward kernels on the card."""
    from repro_torch import models as tm
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.train import batch_tensors, make_train_step
    from repro_torch.tree import as_tree, flatten, tree_map

    out = {}
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    for arch in TRAIN_SMOKE:
        cfg = get_config(arch, smoke=True)
        params = tm.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
        temper(torch, tm, params)
        cpu = {k: v if k == "enc_layers" else tree_map(lambda t: t.float(), v)
               for k, v in as_tree(params).items()}
        card = tree_map(lambda t: t.to(device), cpu)
        batch = SyntheticLMDataset(cfg, 2, 32, seed=SEED).batch(0)
        step = make_train_step(cfg, opt, 1)
        p_cpu, _, m_cpu = step(cpu, adamw_init(cpu, opt), batch_tensors(batch, "cpu"))
        p_card, _, m_card = step(card, adamw_init(card, opt), batch_tensors(batch, device))
        loss_rel = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
        updates, rows = [], 0.0
        for g, r, p0, name in zip(flatten(p_card)[0], flatten(p_cpu)[0], flatten(cpu)[0],
                                  leaf_names(cpu)):
            g = g.cpu()
            if p0.dtype == torch.bfloat16:
                rows = max(rows, worst_row(torch, g, r))
            du, dr = g.double() - p0.double(), r.double() - p0.double()
            updates.append((float((du - dr).norm() / dr.norm().clamp_min(1e-30)), name))
        update, leaf = max(updates)
        tol = SMOKE_BF16_UPDATE_TOL if cfg.is_encoder_decoder else SMOKE_UPDATE_TOL
        print(f"[train] smoke {arch}: card vs CPU, loss {float(m_card['loss']):.5f} vs "
              f"{float(m_cpu['loss']):.5f} (rel {loss_rel:.2e}, tol {SMOKE_LOSS_TOL}), worst "
              f"leaf update {leaf} {update:.3e} of its norm (tol {tol})"
              + (f", worst row of the bf16 encoder's leaves {rows:.3e} (tol "
                 f"{ROW_TOL['bfloat16']})" if cfg.is_encoder_decoder else ""))
        print(f"[sweep] train smoke {arch} updates: "
              + json.dumps({n: float(f"{u:.3e}") for u, n in sorted(updates)[-8:]}))
        out[arch] = {"loss_rel": loss_rel, "worst_update": update, "worst_update_leaf": leaf,
                     "bf16_worst_row": rows}
        if loss_rel > SMOKE_LOSS_TOL or update > tol or rows > ROW_TOL["bfloat16"]:
            errors.append(f"train smoke {arch}: loss {loss_rel}, update {leaf} {update}, "
                          f"bf16 worst row {rows}")
    return out


def train_phases(torch, device, arch_spec, errors) -> dict:
    """tinyllama's gradient check and its B=4 step first, while the card's
    memory is empty; then the scans' families; each phase's time."""
    phases = [("grads", lambda: train_grads(torch, device, errors)),
              ("tinyllama", lambda: train_tinyllama(torch, device, arch_spec, errors)),
              ("grads_scans", lambda: train_grads(torch, device, errors, TRAIN_GRADS_SCANS))]
    for run in TRAIN_SCANS:
        phases.append((run["arch"], lambda run=run: train_scan_model(
            torch, device, arch_spec, errors, **run)))
    phases += [("restart", lambda: train_restart(torch, device, errors)),
               ("restart_hybrid", lambda: train_restart(torch, device, errors,
                                                        TRAIN_RESTART_HYBRID)),
               ("smoke", lambda: train_smoke(torch, device, errors))]
    out = {}
    for name, phase in phases:
        t0 = time.perf_counter()
        out[name] = phase()
        torch.cuda.empty_cache()
        print(f"[time] train {name}: {time.perf_counter() - t0:.1f} s")
    return out


# -- [dryrun]: the dry-run's memory prediction held to the card's --------------

DRYRUN_RATIO = (0.75, 1.25)   # predicted / measured per-device peak
DRYRUN_LIMIT_S = 30.0
# every (micro, remat) row of the [train] cell through the dry-run on a (1, 1)
# mesh, in a worker process that sees no card: started with the run, it
# imports the port while the kernels build, then waits for the rows on its
# stdin (it exits at end of file); a forked worker a row, all at once; it
# prints each row's record, in the rows' order
DRYRUN_WORKER = """
import json, multiprocessing, sys
import torch.distributed.device_mesh
import torch.testing._internal.distributed.fake_pg
import repro_torch.runtime.train
from repro_torch.configs import ShapeCell
from repro_torch.launch.dryrun import run_cell
from repro_torch.optim import AdamWConfig
line = sys.stdin.readline()
if not line:
    sys.exit(0)
arch, B, S, steps, rows = json.loads(line)

def row(nr):
    n, remat = nr
    return run_cell(arch, ShapeCell("chip_train", "train", S, B), False, "tp", verbose=False,
                    cfg_overrides={"remat": remat}, n_micro=n, mesh_shape=(1, 1),
                    opt_cfg=AdamWConfig(warmup_steps=4, total_steps=steps))

with multiprocessing.get_context("fork").Pool(len(rows)) as pool:
    for rec in pool.map(row, rows):
        print(json.dumps(rec))
"""


def start_dryrun_worker() -> subprocess.Popen:
    """The [dryrun] phase's worker (``DRYRUN_WORKER``), started now."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", DRYRUN_WORKER], env=env, cwd=str(ROOT),
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def dryrun_phase(torch, worker, rows, errors) -> dict:
    """The dry-run's per-device peak of every (micro, remat) row the [train]
    phase measured on tinyllama-1.1b, beside the measured peak: the rows
    traced by ``worker`` (:func:`start_dryrun_worker`), a process that sees
    no card (CUDA_VISIBLE_DEVICES empty), a forked worker a row; the card's
    allocated bytes the same before and after."""
    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    arg = json.dumps([TRAIN["arch"], TRAIN["B"], TRAIN["S"], TRAIN["steps"],
                      [[row["micro"], row["remat"]] for row in rows]])
    try:
        stdout, stderr = worker.communicate(arg + "\n", timeout=120)
    finally:
        if worker.poll() is None:
            worker.kill()
    recs = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    if worker.returncode or len(recs) != len(rows):
        errors.append(f"dryrun: exit {worker.returncode}, {len(recs)} records for {len(rows)} "
                      f"rows: {stderr[-2000:]}")
    out = []
    for row, rec in zip(rows, recs):
        pred = rec["memory"]["per_device_total"] / 1e9
        ratio = pred / row["peak_gb"]
        print(f"[dryrun] {TRAIN['arch']} B={TRAIN['B']} S={TRAIN['S']} micro {row['micro']} "
              f"remat {row['remat']}: predicted peak {pred:.2f} GB (arguments "
              f"{rec['memory']['argument_bytes'] / 1e9:.2f}, outputs "
              f"{rec['memory']['output_bytes'] / 1e9:.2f}, temporaries "
              f"{rec['memory']['temp_bytes'] / 1e9:.2f}), measured {row['peak_gb']:.2f} GB, "
              f"ratio {ratio:.3f}; traced in {rec['compile_s']:.1f} s")
        out.append({"micro": row["micro"], "remat": row["remat"], "predicted_gb": pred,
                    "measured_gb": row["peak_gb"], "ratio": ratio,
                    "memory": rec["memory"], "compile_s": rec["compile_s"]})
        if not DRYRUN_RATIO[0] <= ratio <= DRYRUN_RATIO[1]:
            errors.append(f"dryrun micro {row['micro']} remat {row['remat']}: predicted "
                          f"{pred:.2f} GB, measured {row['peak_gb']:.2f} GB, ratio "
                          f"{ratio:.3f} outside {DRYRUN_RATIO}")
    seconds = time.perf_counter() - t0
    after = torch.cuda.memory_allocated()
    print(f"[dryrun] {card_line()}: {len(out)} rows in {seconds:.1f} s; the card's allocated "
          f"bytes {before} before, {after} after")
    if after != before:
        errors.append(f"dryrun: the card's allocated bytes went from {before} to {after}")
    if seconds >= DRYRUN_LIMIT_S:
        errors.append(f"dryrun: {seconds:.1f} s, past {DRYRUN_LIMIT_S} s")
    if not rows:
        errors.append("dryrun: the [train] phase measured no row")
    return {"rows": out, "seconds": seconds, "allocated_before": before,
            "allocated_after": after}


# -- the fleet slice: sharded search, the tuning service, the drift watch,
# -- the observe CLI and the training example ------------------------------

FLEET_WORKERS = (1, 2)
FLEET_RETIME_TOL = 0.10   # the 2-worker winner re-timed within 10% of the 1-worker fastest
FLEET_CLI_KERNELS = ("exb", "flash_attention", "stress", "ssm_scan", "rglru_scan")
SERVICE_FAULTS = dict(drop_request=0.15, drop_response=0.15, duplicate=0.15, reorder=0.1)
# exb launches of the drill's candidates 0, 1, 2: two equals, so the one
# the slowed winner leaves is clearly faster than the watch's lagging EWMA
DRIFT_REPS = [1, 1, 3]
DRIFT_HEALTHY_CALLS = 64
DRIFT_SLOW_REPS = 4       # the winner's launches once it is slowed
DRIFT_LIFECYCLE = ["demoted", "retune_scheduled", "canary_start", "promoted"]
SERVE_CLI = ["--arch", "tinyllama-1.1b", "--full"]
# the tuning run's mixed trace, then a longer one on its DB (32 groups of
# 4): there the watch holds each class's final over several of its EWMA
# windows, the s128 classes most (the trace's groups skew long)
SERVE_CLI_REQUESTS = 64
SERVE_RECALL_REQUESTS = 128
# the CI obs-smoke job's stream run (.github/workflows/ci.yml), at full width
STREAM_CLI = ["--stream", "--requests", "6", "--background-tune", "--chaos-seed", "7",
              "--deadline", "30", "--queue-limit", "4", "--tick-timer", "0.001"]
EXPLAIN_NAMES = ("engine_prefill", "engine_decode", "serve_scheduler")
EXAMPLE_MIN_DROP = 0.20


def cli(args, timeout: float) -> subprocess.CompletedProcess:
    """One of the port's entry points in a process of its own, from the
    repository's root, output captured."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *map(str, args)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def cli_ok(label, out, errors) -> bool:
    """Print a CLI run's last lines; an exit other than 0 is an error."""
    tail = out.stdout.strip().splitlines()[-6:]
    for line in tail:
        print(f"{label}   | {line}")
    if out.returncode != 0:
        errors.append(f"{label}: exit {out.returncode}: {out.stderr.strip()[-800:]}")
        return False
    return True


def parsed(pattern: str, text: str, cast=float):
    m = re.search(pattern, text)
    return cast(m.group(1)) if m else None


def fleet_kernels(torch, device, errors) -> dict:
    """``[fleet]``: flash bf16 at tinyllama-1.1b's width and exb at the GKV
    domain, each searched by a 1-worker and a 2-worker ``FleetCoordinator``
    (thread backend, stride shards) with the registry's measured cost."""
    from repro_torch.core import AutotunedOp, TuningDB, get_kernel, pp_key
    from repro_torch.fleet import FleetCoordinator
    from repro_torch.fleet.workloads import kernel_problem
    from repro_torch.kernels.exb import exb as exb_mod, ref as exb_ref
    from repro_torch.kernels.flash_attention import (
        flash_attention as fa_mod, ref as fa_ref,
    )

    gen = torch.Generator(device=device).manual_seed(SEED)
    cases = (
        ("flash_attention", fa_mod.counter,
         fa_ref.make_inputs(gen, dtype=torch.bfloat16, device=device, **FLASH)),
        ("exb", exb_mod.counter, (exb_ref.make_inputs(gen, dims=EXB_DIMS, device=device),)),
    )
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    timer = Timer(torch, device, l2)
    out = {}
    for name, counter, args in cases:
        spec = get_kernel(name)
        bp = spec.shape_class(*args)
        runs = {}
        for workers in FLEET_WORKERS:
            region, space, cost = kernel_problem(name, device, args)
            n = sum(1 for _ in space.points())
            measured: dict = {}
            lock = threading.Lock()

            def counted(point, cost=cost, measured=measured, lock=lock):
                with lock:
                    measured[pp_key(point)] = measured.get(pp_key(point), 0) + 1
                return cost(point)

            db = TuningDB()
            counter.reset()
            t0 = time.perf_counter()
            res = FleetCoordinator(workers=workers, shard_policy="stride").search(
                space, counted, bp=bp, db=db, space_signature=region.space_signature)
            wall = time.perf_counter() - t0
            launches = counter.launches
            trials = db.trials(bp)
            argmin = json.loads(min(trials, key=lambda k: (trials[k], k)))
            final = db.tuned_point(bp, space_signature=region.space_signature)
            once = sorted(set(measured.values())) == [1] and len(measured) == n
            fresh = AutotunedOp(spec, db=db)
            recall = fresh.resolve(*args)
            torch.cuda.synchronize()
            runs[workers] = dict(points=n, evaluations=res.evaluations, trials=len(trials),
                                 wall_s=wall, winner=res.best.point, winner_ms=res.best.cost * 1e3,
                                 shards=[w.points for w in res.workers], launches=launches,
                                 plain_calls=counter.plain_calls,
                                 recall_evaluations=recall.cost_evaluations,
                                 region=region)
            print(f"[fleet] {name} workers={workers}: {n} points, {res.evaluations} "
                  f"evaluations, {len(trials)} trials, shards {runs[workers]['shards']}, "
                  f"each measured once={once}, winner {res.best.point} "
                  f"{res.best.cost * 1e3:.4f} ms, final={final == res.best.point}, "
                  f"{launches} launches, {counter.plain_calls} plain; fresh op: "
                  f"{recall.cost_evaluations} evaluations, from_cache={recall.from_cache}; "
                  f"wall {wall:.2f} s")
            if not (res.evaluations == n == len(trials) and once):
                errors.append(f"fleet {name} x{workers}: {res.evaluations} evaluations, "
                              f"{len(trials)} trials for {n} points, once={once}")
            if res.best.point != argmin or final != argmin:
                errors.append(f"fleet {name} x{workers}: winner {res.best.point}, final "
                              f"{final}, argmin of the merged trials {argmin}")
            if not recall.from_cache or recall.cost_evaluations or \
                    recall.region.selected != res.best.point:
                errors.append(f"fleet {name} x{workers}: a fresh op did not recall the final")
            if launches < n or counter.plain_calls:
                errors.append(f"fleet {name} x{workers}: {launches} launches for {n} points, "
                              f"{counter.plain_calls} plain calls")
        # the 2-worker winner beside the 1-worker run's fastest point, timed
        # in turns on the same inputs
        one, two = runs[1], runs[2]
        fn1 = one["region"].instantiate(one["winner"])
        fn2 = two["region"].instantiate(two["winner"])
        t1, t2 = [], []
        for _ in range(3):
            t1.append(timer.ms(lambda: fn1(*args)))
            t2.append(timer.ms(lambda: fn2(*args)))
        one_ms, two_ms = min(t1), min(t2)
        print(f"[fleet] {name}: re-timed 2-worker winner {two['winner']} {two_ms:.4f} ms "
              f"beside the 1-worker winner {one['winner']} {one_ms:.4f} ms "
              f"(ratio {two_ms / one_ms:.3f}); wall 1 worker {one['wall_s']:.2f} s, "
              f"2 workers {two['wall_s']:.2f} s")
        if two_ms > (1 + FLEET_RETIME_TOL) * one_ms:
            errors.append(f"fleet {name}: the 2-worker winner {two_ms:.4f} ms is more than "
                          f"{FLEET_RETIME_TOL:.0%} over the 1-worker fastest {one_ms:.4f} ms")
        for r in runs.values():
            r.pop("region")
        out[name] = dict(runs=runs, retimed_ms={"1": one_ms, "2": two_ms})
    return out


def fleet_cli(errors) -> dict:
    """``[fleet]``: ``launch.fleet`` for every kernel at the workloads'
    shapes (2 thread workers on the card), and the demo problem on the spawn
    backend against a single worker (``--check-equivalence``).  The six
    processes run at once: each one's exit and evaluation count are
    checked; the winners they print were timed beside each other on one
    card, so they are no measurement."""
    runs = {name: ["--kernel", name, "--workers", "2"] for name in FLEET_CLI_KERNELS}
    runs["demo_spawn"] = ["--kernel", "demo", "--workers", "2", "--backend", "spawn",
                          "--check-equivalence"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.fleet", *flags], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for name, flags in runs.items()}
    out = {}
    try:
        for name, proc in procs.items():
            try:
                stdout, stderr = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                errors.append(f"fleet cli {name}: no exit in 300 s")
                continue
            res = subprocess.CompletedProcess(proc.args, proc.returncode, stdout, stderr)
            ok = cli_ok(f"[fleet] cli {name}", res, errors)
            evals = parsed(r"\((\d+) total evaluations\)", stdout, int)
            space = parsed(r"space: (\d+) candidates", stdout, int)
            print(f"[fleet] cli {name}: exit {res.returncode}, {space} candidates, {evals} "
                  f"evaluations")
            if ok and (evals is None or evals != space):
                errors.append(f"fleet cli {name}: {evals} evaluations for {space} candidates")
            if ok and name == "demo_spawn" and "equivalence OK" not in stdout:
                errors.append("fleet cli demo: no 'equivalence OK' line")
            out[name] = dict(rc=res.returncode, candidates=space, evaluations=evals)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    print(f"[fleet] cli: the six at once, {time.perf_counter() - t0:.1f} s")
    return out


def service_phase(torch, device, errors) -> dict:
    """``[service]``: a ``TuningService`` on 127.0.0.1 over HTTP; two hosts
    measure their halves of exb's space through seeded lossy transports;
    a third client recalls the union's final with 0 evaluations, and a
    client of another platform gets only a warm-start seed."""
    from repro_torch.core import AutotunedOp, TuningDB, get_kernel
    from repro_torch.fleet import (
        DeviceFingerprint, FaultInjectionTransport, FleetCoordinator, HTTPTransport,
        ServiceClient, TuningService, device_bp_entries, serve_http,
    )
    from repro_torch.fleet.workloads import kernel_problem
    from repro_torch.kernels.exb import exb as exb_mod, ref as exb_ref
    from repro_torch.runtime import BackgroundTuner

    gen = torch.Generator(device=device).manual_seed(SEED)
    args = (exb_ref.make_inputs(gen, dims=EXB_DIMS, device=device),)
    spec = get_kernel("exb")
    bp = spec.shape_class(*args).with_entries(**device_bp_entries(device))
    service = TuningService()
    server = serve_http(service, host="127.0.0.1", port=0)
    url = "http://%s:%d" % server.server_address[:2]
    out: dict = {"url_host": "127.0.0.1"}
    try:
        hosts, faults = [], 0
        for host in range(2):
            region, space, cost = kernel_problem("exb", device, args)
            ft = FaultInjectionTransport(HTTPTransport(url), seed=11 + host, **SERVICE_FAULTS)
            client = ServiceClient(ft, retries=8, jitter_seed=host)
            exb_mod.counter.reset()
            res = FleetCoordinator(workers=2, backend="remote", service=client, hosts=2,
                                   host_index=host).search(
                space, cost, bp=bp, db=TuningDB(), space_signature=region.space_signature)
            faults += ft.stats.faults
            hosts.append(dict(evaluations=res.evaluations, winner=res.best.point,
                              synced=res.service_synced, faults=ft.stats.faults,
                              launches=exb_mod.counter.launches))
            print(f"[service] host {host}/2: {res.evaluations} evaluations of "
                  f"{space.size()} points, synced={res.service_synced}, winner "
                  f"{res.best.point} {res.best.cost * 1e3:.4f} ms, injected faults "
                  f"{vars(ft.stats)}")
            if not res.service_synced:
                errors.append(f"service host {host}: the merge barrier did not sync")
        union = service.db.trials(bp)
        argmin = json.loads(min(union, key=lambda k: (union[k], k)))
        n = space.size()
        print(f"[service] union: {len(union)} trials of {n} points; host 1's final "
              f"{hosts[1]['winner']}, the union's argmin {argmin}, the service's final "
              f"{service.db.tuned_point(bp)}; {faults} faults injected in all")
        if len(union) != n or sum(h["evaluations"] for h in hosts) != n:
            errors.append(f"service: {len(union)} trials, "
                          f"{[h['evaluations'] for h in hosts]} evaluations for {n} points")
        if hosts[1]["winner"] != argmin or service.db.tuned_point(bp) != argmin:
            errors.append(f"service: host 1's final {hosts[1]['winner']} is not the "
                          f"union's argmin {argmin}")
        if not faults:
            errors.append("service: the fault injector fired no fault")

        # a third host, device-keyed: its tuner pulls the final and recalls it
        op = AutotunedOp(spec, db=TuningDB(), device_key=True)
        client = ServiceClient(HTTPTransport(url), retries=3)
        exb_mod.counter.reset()
        with BackgroundTuner(service=client) as tuner:
            state = tuner.submit(op, *args)
            drained = tuner.drain(timeout=60)
        recalled = (drained and state.from_cache and state.cost_evaluations == 0
                    and tuner.pulled_labels == ["exb"] and state.region.selected == argmin)
        print(f"[service] third host: pulled {tuner.pulled_labels}, from_cache="
              f"{state.from_cache}, {state.cost_evaluations} evaluations, selected "
              f"{state.region.selected}, {exb_mod.counter.launches} launches")
        if not recalled or tuner.errors:
            errors.append(f"service: the third host did not recall the final "
                          f"({tuner.errors})")

        # a host of another platform: a seed to warm-start from, never a final
        here = DeviceFingerprint.from_bp_entries(device_bp_entries(device))
        other = DeviceFingerprint(backend=here.backend, platform="NVIDIA A100-SXM4-80GB",
                                  device_count=here.device_count, host_cores=here.host_cores,
                                  memory_gib=here.memory_gib, schema=here.schema)
        foreign = spec.shape_class(*args).with_entries(**other.bp_entries())
        resp = ServiceClient(HTTPTransport(url), retries=3).pull(foreign)
        local = TuningDB()
        if resp.get("found"):
            local.merge({resp["fingerprint"]: resp["entry"]})
        seed = local.nearest_tuned(foreign)
        print(f"[service] another platform: found={resp.get('found')}, final recalled="
              f"{local.tuned_point(foreign) is not None}, warm-start seed "
              f"{seed and seed['point']} at distance {seed and seed['distance']}")
        if resp.get("found") != "nearest" or local.tuned_point(foreign) is not None \
                or not seed or seed["point"] != argmin:
            errors.append(f"service: another platform's pull gave {resp.get('found')}")

        res = cli(["-m", "repro_torch.launch.observe", "metrics", "--url", f"{url}/metrics"], 120)
        cli_ok("[service] observe metrics --url", res, errors)
        out.update(hosts=hosts, union_trials=len(union), final=argmin, faults=faults,
                   third_host=dict(evaluations=state.cost_evaluations, recalled=recalled),
                   other_platform=resp.get("found"), metrics_rc=res.returncode)
    finally:
        server.shutdown()
        server.server_close()
    return out


def drift_drill(torch, device, errors) -> dict:
    """``[drift]``: a test kernel whose candidate ``i`` launches exb
    ``reps[i]`` times, tuned, then called with every call monitored: a
    healthy run must make no transition; slowing the winner must demote,
    re-tune (measuring again), canary and promote the other one-launch
    candidate."""
    from repro_torch.core import (
        ATRegion, AutotunedOp, BasicParams, KernelSpec, ParamSpace, PerfParam, TuningDB,
    )
    from repro_torch.fleet import DriftMonitor
    from repro_torch.kernels.exb import exb as exb_mod, ref as exb_ref

    gen = torch.Generator(device=device).manual_seed(SEED)
    inp = exb_ref.make_inputs(gen, dims=EXB_DIMS, device=device)
    reps = list(DRIFT_REPS)

    def instantiate(point):
        def run(x):
            for _ in range(reps[point["i"]]):
                out = exb_mod.exb(x)
            return out
        return run

    spec = KernelSpec(
        name="drift_exb",
        make_region=lambda bp: ATRegion(
            "drift_exb", ParamSpace([PerfParam("i", tuple(range(len(reps))))]), instantiate),
        shape_class=lambda x: BasicParams.make(kernel="drift_exb", backend="cuda"),
    )
    monitor = DriftMonitor(factor=2.0)
    db = TuningDB()
    # the straggler selector runs at its default tolerance beside the watch,
    # on the same samples: a healthy run must switch neither
    op = AutotunedOp(spec, db=db, monitor_every=1, drift=monitor)
    exb_mod.counter.reset()
    for _ in range(DRIFT_HEALTHY_CALLS):
        op(inp)
    torch.cuda.synchronize()
    (state,) = op.states().values()
    recorded = db.best_cost(state.bp)
    watch = monitor._watches.get(state.bp.fingerprint())
    switches = state.selector.switches
    healthy = dict(calls=DRIFT_HEALTHY_CALLS, transitions=len(monitor.transitions),
                   selector_switches=switches, checks=monitor.checks,
                   winner=dict(state.region.selected), recorded_ms=recorded * 1e3,
                   ewma_ms=watch.ewma * 1e3 if watch and watch.ewma else None,
                   host_bound_samples=op.host_bound_samples,
                   launches=exb_mod.counter.launches)
    print(f"[drift] healthy: {DRIFT_HEALTHY_CALLS} monitored calls, "
          f"{len(monitor.transitions)} transitions over {monitor.checks} checks, "
          f"{op.host_bound_samples} samples dropped (the host's enqueue outlasted the "
          f"spin), {switches} selector switches; winner {state.region.selected} "
          f"recorded {recorded * 1e3:.4f} ms, observed EWMA {healthy['ewma_ms']} ms "
          f"(CUDA events), {exb_mod.counter.launches} exb launches")
    winner = state.region.selected
    if monitor.transitions or switches or not monitor.checks or reps[winner["i"]] != 1:
        errors.append(f"drift: a healthy run made transitions {monitor.transitions} "
                      f"and {switches} selector switches over {monitor.checks} checks, "
                      f"or tuned {winner}")
    evaluations = state.cost_evaluations
    dropped = op.host_bound_samples
    trials_before = db.trials(state.bp)
    reps[winner["i"]] = DRIFT_SLOW_REPS
    calls = 0
    while calls < 64 and not any(k == "promoted" or k == "rolled_back"
                                 for _, k in monitor.transitions):
        op(inp)
        calls += 1
    torch.cuda.synchronize()
    kinds = [e["kind"] for e in db.events(state.bp) if e["kind"] in DRIFT_LIFECYCLE
             + ["rolled_back", "retune_failed"]]
    trials_after = db.trials(state.bp)
    remeasured = state.cost_evaluations - evaluations
    key = json.dumps(winner)
    final = db.tuned_point(state.bp)
    print(f"[drift] slowed: candidate {winner['i']} at {DRIFT_SLOW_REPS} launches; after "
          f"{calls} calls the event log holds {kinds}; the re-tune measured {remeasured} "
          f"points again (candidate {winner['i']} {trials_before.get(key)} -> "
          f"{trials_after.get(key)} s); now {state.region.selected}, final {final}; "
          f"{state.selector.switches - switches} selector switches, "
          f"{op.host_bound_samples - dropped} samples dropped")
    if kinds != DRIFT_LIFECYCLE or remeasured < len(reps) or final == winner:
        errors.append(f"drift: event log {kinds}, {remeasured} points measured again, "
                      f"final {final}")
    return dict(healthy=healthy, slowed_calls=calls, events=kinds, remeasured=remeasured,
                slowed_selector_switches=state.selector.switches - switches,
                slowed_host_bound_samples=op.host_bound_samples - dropped,
                final=db.tuned_point(state.bp), launches=exb_mod.counter.launches)


def serve_cli_phase(errors, tmp: Path) -> dict:
    """``[drift]``/``[observe]``: the serve CLI at tinyllama-1.1b's full
    width, the static Server with the fleet's flags, then the streaming
    engine traced (the CI obs-smoke job's run) and its files through the
    observe CLI."""
    out = {}
    db = tmp / "serve_db.json"
    # first the tuning run, then a run on its DB: every class recalled, the
    # watch holds each final from the first observations on
    for key, tag, requests in (("server", "serve", SERVE_CLI_REQUESTS),
                               ("server_recall", "serve recall", SERVE_RECALL_REQUESTS)):
        t0 = time.perf_counter()
        res = cli(["-m", "repro_torch.launch.serve", *SERVE_CLI, "--trace", "mixed",
                   "--requests", requests, "--background-tune", "--fleet-workers", 2,
                   "--drift-factor", 2, "--device-key", "--tuning-db", db], 600)
        secs = time.perf_counter() - t0
        cli_ok(f"[drift] {tag}", res, errors)
        hot = parsed(r"hot-path tuning evaluations: (\d+)", res.stdout, int)
        background = parsed(r"\((\d+) evaluations off the hot path\)", res.stdout, int)
        transitions = parsed(r"drift transitions: (\d+)", res.stdout, int)
        checks = parsed(r"(\d+) observations held against a recorded final", res.stdout, int)
        by_class = {k: int(v) for k, v in re.findall(
            r"([\w/]+)=(\d+)", parsed(r"drift checks by class: (.*)", res.stdout, str) or "")}
        demotions = res.stdout.count("demoted")
        tok_s = parsed(r"tokens, ([\d.]+) tok/s", res.stdout)
        warnings = [line for line in res.stdout.splitlines() if line.startswith("WARNING")]
        print(f"[drift] {tag} tinyllama-1.1b full, mixed trace of {requests}: {tok_s} tok/s, "
              f"{hot} hot-path evaluations, {background} off it, {transitions} drift "
              f"transitions ({demotions} demotions) over {checks} observations held against "
              f"a final {by_class}, {len(warnings)} warnings, {secs:.1f} s")
        if res.returncode == 0 and (hot != 0 or transitions != 0 or not checks or warnings):
            errors.append(f"drift {tag}: {hot} hot-path evaluations, {transitions} "
                          f"transitions over {checks} checks, {warnings}")
        out[key] = dict(rc=res.returncode, requests=requests, tok_s=tok_s,
                        hot_path_evaluations=hot, background_evaluations=background,
                        transitions=transitions, checks=checks, class_checks=by_class,
                        seconds=secs)

    trace, metrics, sdb = tmp / "obs_trace.json", tmp / "obs_metrics.prom", tmp / "obs_db.json"
    t0 = time.perf_counter()
    res = cli(["-m", "repro_torch.launch.serve", *SERVE_CLI, *STREAM_CLI, "--trace-out", trace,
               "--metrics-out", metrics, "--tuning-db", sdb], 600)
    secs = time.perf_counter() - t0
    cli_ok("[observe] stream", res, errors)
    print(f"[observe] stream tinyllama-1.1b full (the obs-smoke run): exit {res.returncode}, "
          f"{secs:.1f} s")
    obs = {}
    for cmd, flag, path in (("trace", "--path", trace), ("metrics", "--path", metrics),
                            ("explain", "--db", sdb)):
        r = cli(["-m", "repro_torch.launch.observe", cmd, flag, path], 120)
        cli_ok(f"[observe] {cmd}", r, errors)
        obs[cmd] = r.returncode
        if cmd == "explain":
            named = {n: n in r.stdout for n in EXPLAIN_NAMES}
            print(f"[observe] explain names {named}")
            if not all(named.values()):
                errors.append(f"observe explain: missing {named}")
            obs["named"] = named
        else:
            print(f"[observe] {cmd}: {r.stdout.strip().splitlines()[0] if r.stdout else ''}")
    out["stream"] = dict(rc=res.returncode, seconds=secs, observe=obs)
    return out


def example_phase(errors, tmp: Path) -> dict:
    """``[example]``: ``examples/torch_train_lm.py`` on the card at its
    defaults: the loss must fall by at least 20 %."""
    t0 = time.perf_counter()
    res = cli([ROOT / "examples" / "torch_train_lm.py", "--device", "cuda",
               "--ckpt-dir", tmp / "example_ckpt"], 600)
    secs = time.perf_counter() - t0
    cli_ok("[example] torch_train_lm", res, errors)
    drop = parsed(r"\((-?[\d.]+)% drop\)", res.stdout)
    steps_s = parsed(r"\(([\d.]+) steps/s on", res.stdout)
    step_ms = parsed(r"median step time: ([\d.]+) ms", res.stdout)
    print(f"[example] torch_train_lm: loss drop {drop}%, median step {step_ms} ms, "
          f"{steps_s} steps/s, {secs:.1f} s in all")
    if res.returncode == 0 and (drop is None or drop < EXAMPLE_MIN_DROP * 100):
        errors.append(f"example: loss drop {drop}%")
    return dict(rc=res.returncode, drop_pct=drop, step_ms=step_ms, steps_s=steps_s,
                seconds=secs)


def fleet_phases(torch, device, errors) -> dict:
    """The fleet slice's phases, each timed; the card's memory is handed
    back before the entry points run in processes of their own."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        for name, phase in (
                ("fleet", lambda: fleet_kernels(torch, device, errors)),
                ("service", lambda: service_phase(torch, device, errors)),
                ("drift", lambda: drift_drill(torch, device, errors)),
                ("fleet_cli", lambda: fleet_cli(errors)),
                ("serve_cli", lambda: serve_cli_phase(errors, Path(tmp))),
                ("example", lambda: example_phase(errors, Path(tmp)))):
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            out[name] = phase()
            out[name]["seconds_all"] = time.perf_counter() - t0
            print(f"[time] {name}: {out[name]['seconds_all']:.1f} s")
    return out


def main_path(torch, name, args, plain_out, dtype, db_path, errors, tol=None, view=None):
    """Cold tune, fresh-op recall, fast path; returns the cold op's state
    and the host seconds of the cold call and of the recalling call.
    ``view`` picks what of the output is held against ``plain_out``."""
    from repro_torch.core import TuningDB, autotuned

    t0 = time.perf_counter()
    op = autotuned(name, db=TuningDB(db_path))
    out = op(*args)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    state = op.resolve(*args)
    trials = TuningDB(db_path).trials(state.bp)
    print(f"[main] {name}: cold tune, {state.cost_evaluations} evaluations, "
          f"{state.prescreen_evaluations} prescreened, winner {state.region.selected}, "
          f"{tune_s:.3f} s")
    for key, cost in sorted(trials.items(), key=lambda kv: kv[1]):
        print(f"[main] {name}:   measured {key} {cost * 1e3:.4f} ms")
    if state.cost_evaluations <= 0:
        errors.append(f"{name}: cold tune made no evaluations")
    err, row, failed = max_err(torch, (view or outputs)(out), plain_out, dtype, tol)
    print(f"[main] {name}: output vs plain version: max abs err {err:.3e}, "
          f"row error {row:.3e}")
    if failed:
        errors.append(f"{name}: main-path output off the plain version by {err}, "
                      f"row error {row}; failed {failed}")

    t0 = time.perf_counter()
    fresh = autotuned(name, db=TuningDB(db_path))
    fresh(*args)
    torch.cuda.synchronize()
    recall_s = time.perf_counter() - t0
    recall = fresh.resolve(*args)
    slow = fresh.slow_resolutions
    fresh(*args)
    fresh(*args)
    torch.cuda.synchronize()
    fast = fresh.slow_resolutions == slow and len(fresh._fast) == 1
    print(f"[main] {name}: fresh op, {recall.cost_evaluations} evaluations, "
          f"from_cache={recall.from_cache}, fast path={fast}, {recall_s:.3f} s")
    if recall.cost_evaluations != 0 or not recall.from_cache or not fast:
        errors.append(f"{name}: fresh op did not recall through the fast path")
    return state, tune_s, recall_s


def run() -> int:
    started = time.perf_counter()
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail(f"the repository's src/repro_torch is not beside {__file__}")
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import torch.nn.functional as F

    from repro_torch.core import (
        ExhaustiveSearch, TuningDB, autotuned, bucket_pow2, detect, pp_key,
    )
    from repro_torch.kernels import _build
    from repro_torch.kernels.exb import exb as exb_mod, ops as exb_ops, ref as exb_ref
    from repro_torch.kernels.flash_attention import (
        flash_attention as fa_mod, ops as fa_ops, ref as fa_ref,
    )
    from repro_torch.kernels.rglru_scan import (
        ops as rg_ops, ref as rg_ref, rglru_scan as rg_mod,
    )
    from repro_torch.kernels.ssm_scan import ops as ssm_ops, ref as ssm_ref, ssm_scan as ssm_mod
    from repro_torch.kernels.stress import ops as st_ops, ref as st_ref, stress as st_mod
    from repro_torch.apps import degrees as app_degrees, gkv, paper_figures, seism3d
    from repro_torch.core import ExchangeVariant, launch_shape
    from repro_torch.kernels.loop_nest import loop_nest as ln_mod

    card = card_line()
    print(card)
    device = torch.device("cuda:0")
    arch = detect(device)
    print(f"[arch] {arch}")

    dryrun_worker = start_dryrun_worker()  # imports the port while the kernels build
    t0 = time.perf_counter()
    for name in _build.sources():
        _build.library(name)
    print(f"[build] {sorted(_build.sources())} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s)")
    logs = sorted(_build.build_dir().glob("*/*.log"), key=lambda p: p.stat().st_mtime)
    for log in logs[-len(_build.sources()):]:
        if log.stem in ("flash_attention", "flash_attention_sm90", "ssm_scan", "rglru_scan",
                        "flash_attention_bwd", "flash_attention_bwd_f32", "ssm_scan_bwd",
                        "rglru_scan_bwd"):
            continue  # per instantiation below
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {log.stem}: {line.strip()}")
    flash_tiles = {}  # dtype -> {(hd, block_q, block_kv): (registers, spill bytes)}
    for dtype_name, stem, kernel, table in (
            ("bf16", "flash_attention_sm90", "flash_fwd_sm90", fa_mod.SM90_TILES),
            ("f32", "flash_attention", "flash_fwd_tf32x3", fa_mod.F32_TILES)):
        log = (_build.build_dir() / _build._digest() / f"{stem}.log").read_text()
        tiles = flash_tiles[dtype_name] = {}
        lse_tiles = {}  # the instantiations with the lse output (training)
        for name, entry in ptxas_entries(log).items():
            tile = re.search(kernel + r"ILi(\d+)ELi(\d+)ELi(\d+)ELb([01])E", name)
            if tile:
                key = tuple(map(int, tile.groups()[:3]))
                (lse_tiles if tile.group(4) == "1" else tiles)[key] = entry
        long_name = "bfloat16" if dtype_name == "bf16" else "float32"
        for (hd, bq, bkv), (regs, spill) in sorted(tiles.items()):
            lse_regs, lse_spill = lse_tiles.get((hd, bq, bkv), (0, -1))
            print(f"[ptxas] flash {dtype_name} (hd={hd}, {bq}, {bkv}): {regs} registers, "
                  f"{spill} B spilled, {fa_mod.ctas_per_sm(hd, bq, bkv, long_name)} CTAs/SM; "
                  f"with lse {lse_regs} registers, {lse_spill} B spilled")
        if set(lse_tiles) != set(table) or max(s for _, s in lse_tiles.values()):
            return fail(f"flash {dtype_name} lse: {len(lse_tiles)} instantiations for "
                        f"{len(table)} tiles, or a spill")
        for line in log.splitlines():
            if "Performance" in line:
                print(f"[ptxas] flash {dtype_name}: {line.strip()}")
        # the hd-256 tiles keep their spills, if any, printed here and in PERF.md
        spill = max((s for t, (_, s) in tiles.items() if t[0] != 256), default=0)
        spill256 = max((s for t, (_, s) in tiles.items() if t[0] == 256), default=0)
        print(f"[build] flash {dtype_name}: {len(tiles)} instantiations, registers "
              f"{min(r for r, _ in tiles.values())}-{max(r for r, _ in tiles.values())}, "
              f"max spill {spill} B below hd 256, {spill256} B at hd 256")
        if set(tiles) != set(table) or spill:
            return fail(f"flash {dtype_name}: {len(tiles)} instantiations for {len(table)} "
                        f"tiles, spill {spill} B")
    sm90 = flash_tiles["bf16"]
    fa_spill = max(s for tiles in flash_tiles.values() for _, s in tiles.values())
    scan_spill, scan_count = 0, 0
    for stem, kernel, knob in (("ssm_scan", "ssm_kernel", "states"),
                               ("rglru_scan", "rglru_kernel", "chunk/split")):
        log = (_build.build_dir() / _build._digest() / f"{stem}.log").read_text()
        for name, (regs, spill) in sorted(ptxas_entries(log).items()):
            inst = re.search(kernel + r"I(f|13__nv_bfloat16)Li(\d+)E(Lb1E)?", name)
            if not inst:
                continue
            dtype_name = "f32" if inst.group(1) == "f" else "bf16"
            general = ", any N" if inst.group(3) else ""
            print(f"[ptxas] {stem} {dtype_name} ({knob} {inst.group(2)}{general}): {regs} "
                  f"registers, {spill} B spilled")
            scan_spill, scan_count = max(scan_spill, spill), scan_count + 1
    print(f"[build] scans: {scan_count} instantiations, max spill {scan_spill} B")
    # ssm_scan: each states count for N a power of two up to 32, and for any N
    if scan_count != 2 * (2 * len(ssm_mod.STATES) + len(rg_mod.SEGMENTS)) or scan_spill:
        return fail(f"scans: {scan_count} instantiations, spill {scan_spill} B")
    # the scans' backward kernels: ssm_scan_bwd's at each (seg, channels,
    # time lanes), its maps of sweep 1 and sweep 2, its reduce a dtype and
    # the kernel chaining the trips; rglru_scan_bwd's maps and gradient
    # passes at each segment length, its chain and its reduce
    bwd_scan_spill, bwd_scan_count = 0, 0
    for stem, kernel in (("ssm_scan_bwd", "ssm_bwd_kernel"),
                         ("rglru_scan_bwd", "rglru_bwd_kernel")):
        log = (_build.build_dir() / _build._digest() / f"{stem}.log").read_text()
        for name, (regs, spill) in sorted(ptxas_entries(log).items()):
            inst = re.search(kernel + r"I(f|13__nv_bfloat16)Li(\d+)E(?:Li(\d+)ELi(\d+)E)?"
                             r"(?:Lb([01])E)?", name)
            red = re.search(r"(ssm_bwd_reduce|rglru_bwd_reduce|ssm_bwd_starts|rglru_bwd_chain)",
                            name)
            if inst and inst.group(3):
                dtype_name = "f32" if inst.group(1) == "f" else "bf16"
                what = (f"{dtype_name} (seg {inst.group(2)}, channels {inst.group(3)}, time lanes "
                        f"{inst.group(4)}, {'maps' if inst.group(5) == '1' else 'sweep 2'})")
            elif inst:
                dtype_name = "f32" if inst.group(1) == "f" else "bf16"
                what = (f"{dtype_name} (segment {inst.group(2)}, "
                        f"{'gradients' if inst.group(5) == '1' else 'maps'})")
            elif red and red.group(1) in ("ssm_bwd_starts", "rglru_bwd_chain"):
                what = "starts" if red.group(1) == "ssm_bwd_starts" else "chain"
            elif red:
                what = "reduce" + (" f32" if "IfE" in name else " bf16" if "bfloat16" in name
                                   else "")
            else:
                continue
            print(f"[ptxas] {stem} {what}: {regs} registers, {spill} B spilled")
            bwd_scan_spill, bwd_scan_count = max(bwd_scan_spill, spill), bwd_scan_count + 1
    print(f"[build] scans' backward: {bwd_scan_count} instantiations, max spill "
          f"{bwd_scan_spill} B")
    # ssm_scan_bwd: sweep 2 at each compiled tile, sweep 1's maps at each of
    # theirs and a reduce a dtype, and the starts; rglru_scan_bwd: the maps
    # and gradient passes at 4 segment lengths a dtype, the chain and the
    # reduce
    want = (2 * (len(ssm_mod.BWD_TILES) + len(ssm_mod.BWD_MAPS_TILES) + 1) + 1
            + 2 * 2 * len(rg_mod.SEGMENTS) + 2)
    if bwd_scan_count != want or bwd_scan_spill:
        return fail(f"scans' backward: {bwd_scan_count} instantiations for {want}, spill "
                    f"{bwd_scan_spill} B")
    # the flash backward, on mma.sync (float32) and on wgmma (bf16): the dq
    # pass and the dk/dv pass with and without kv_split's partials a tile,
    # and the delta and reduce passes
    bwd_spill, bwd_count, sm90_count = 0, 0, 0
    for stem in ("flash_attention_bwd_f32", "flash_attention_bwd_sm90"):
        log = (_build.build_dir() / _build._digest() / f"{stem}.log").read_text()
        for name, (regs, spill) in sorted(ptxas_entries(log).items()):
            inst = re.search(r"(flash_bwd_dq|flash_bwd_dkv)ILi(\d+)ELi(\d+)ELi(\d+)E(Lb1E)?",
                             name)
            wg = re.search(r"(flash_bwd_dq|flash_bwd_dkv)_sm90ILi(\d+)ELi(\d+)ELi(\d+)E(Lb1E)?",
                           name)
            if inst:
                split = ", kv_split partials" if inst.group(5) else ""
                print(f"[ptxas] flash bwd f32 {inst.group(1)[10:]} (hd={inst.group(2)}, "
                      f"{inst.group(3)}, {inst.group(4)}{split}): {regs} registers, {spill} B "
                      f"spilled")
                bwd_count += 1
            elif wg:
                split = ", kv_split partials" if wg.group(5) else ""
                print(f"[ptxas] flash bwd bf16 wgmma {wg.group(1)[10:]} (hd={wg.group(2)}, "
                      f"{wg.group(3)}, {wg.group(4)}{split}): {regs} registers, {spill} B spilled")
                sm90_count += 1
            elif "flash_bwd" in name:
                print(f"[ptxas] flash bwd {stem} {name[-60:]}: {regs} registers, {spill} B "
                      f"spilled")
            else:
                continue
            bwd_spill = max(bwd_spill, spill)
        for line in log.splitlines():
            if "Performance" in line:
                print(f"[ptxas] flash bwd {stem}: {line.strip()}")
    mma_tiles = len(fa_mod.BWD_F32_TILES)
    print(f"[build] flash bwd: {bwd_count} mma.sync instantiations, {sm90_count} wgmma, max "
          f"spill {bwd_spill} B")
    if (bwd_count != 3 * mma_tiles or sm90_count != 3 * len(fa_mod.BWD_SM90_TILES)
            or bwd_spill):
        return fail(f"flash bwd: {bwd_count} mma.sync instantiations for {mma_tiles} tiles, "
                    f"{sm90_count} wgmma for {len(fa_mod.BWD_SM90_TILES)}, spill {bwd_spill} B")
    optin = fa_mod.smem_optin(device)
    if optin < arch.smem_per_block:
        return fail(f"arch plans {arch.smem_per_block} B of shared memory, card allows {optin}")

    errors: list = []
    # -- the training slice first, while the card's memory is its own: the
    # joint search's remat-none step peaks at 68.6 GB of the 80 -----------
    t0 = time.perf_counter()
    train = train_phases(torch, device, arch, errors)
    print(f"[time] train phases: {time.perf_counter() - t0:.1f} s")
    if errors:
        for e in errors:
            print(f"[error] {e}", file=sys.stderr)
        return fail(f"{len(errors)} train check(s) failed")
    torch.cuda.empty_cache()

    # -- the dry-run's memory prediction against the [train] rows ----------
    dryrun = dryrun_phase(torch, dryrun_worker, train["tinyllama"]["assignments"], errors)
    print(f"[time] dryrun phase: {dryrun['seconds']:.1f} s")
    if errors:
        for e in errors:
            print(f"[error] {e}", file=sys.stderr)
        return fail(f"{len(errors)} dryrun check(s) failed")

    timer = Timer(torch, device, arch.l2_bytes)
    gen = torch.Generator(device=device).manual_seed(SEED)

    # -- kernels: every emitted point against the plain version ------------
    inp = exb_ref.make_inputs(gen, dims=EXB_DIMS, device=device)
    exb_plain_out = exb_mod.exb_plain(inp)
    exb_region = exb_ops.exb_region(dims=EXB_DIMS, arch=arch)
    exb_err, exb_row, exb_times = sweep(
        torch, "exb f32 (16,16,128,65)", exb_region,
        lambda p: exb_mod.exb_cuda(inp, **p), exb_plain_out, "float32",
        timer, exb_mod.counter, errors,
    )

    flash_cases = {}
    fa_err = fa_row = 0.0
    flash_shapes = [("bfloat16", torch.bfloat16, FLASH), ("float32", torch.float32, FLASH),
                    ("bfloat16", torch.bfloat16, dict(FLASH, S=2000)),
                    ("float32", torch.float32, dict(FLASH, S=2000)),
                    ("bfloat16", torch.bfloat16, FLASH_HD128)]
    # 3a: head dims on a larger tile, and hd 64 at phi-2's heads beside hd 80
    flash_shapes += [(name, dtype, shape)
                     for shape in (FLASH_HD80, dict(FLASH_HD80, hd=64), FLASH_HD256)
                     for name, dtype in (("bfloat16", torch.bfloat16),
                                         ("float32", torch.float32))]
    for dtype_name, dtype, shape in flash_shapes:
        S = shape["S"]
        qkv = fa_ref.make_inputs(gen, dtype=dtype, device=device, **shape)
        plain_out = (fa_mod.attention_plain(*qkv),)
        region = fa_ops.flash_region(S, shape["hd"], dtype_name, arch=arch,
                                     heads=bucket_pow2(shape["B"] * shape["H"]))
        for point in region.space.points():
            model = fa_mod.smem_bytes(point["block_q"], point["block_kv"],
                                      shape["hd"], qkv[0].element_size())
            native = fa_mod.smem_bytes_native(point["block_q"], point["block_kv"],
                                              shape["hd"], dtype)
            if model != native or model > optin:
                errors.append(f"flash {point}: smem model {model}, kernel {native}, limit {optin}")
        label = (f"flash {dtype_name} ({shape['B']},{S},{shape['H']}|{shape['KV']},"
                 f"{shape['hd']})")
        err, row, times = sweep(
            torch, label, region,
            lambda p, qkv=qkv: fa_mod.flash_attention_cuda(*qkv, **p),
            plain_out, dtype_name, timer, fa_mod.counter, errors,
        )
        fa_err, fa_row = max(fa_err, err), max(fa_row, row)
        for point in region.space.points():  # the hint's rank beside the card's
            hint = region.hints[pp_key(point)]
            print(f"[hint] {label} {pp_key(point)}: est {hint['est_s'] * 1e3:.4f} ms "
                  f"(latency {hint['latency_s'] * 1e3:.4f}), measured "
                  f"{times[pp_key(point)]:.4f} ms")
        flash_cases[(dtype_name, S, shape["hd"], shape["H"], shape["KV"])] = (
            qkv, plain_out, times)

    # one non-causal call a dtype, at hd 64, on the fastest swept tile
    for dtype_name in ("bfloat16", "float32"):
        qkv, _, times = flash_cases[(dtype_name, 2048, 64, FLASH["H"], FLASH["KV"])]
        point = json.loads(min(times, key=times.get))
        out = fa_mod.flash_attention_cuda(*qkv, **point, causal=False)
        torch.cuda.synchronize()
        err, row, failed = max_err(torch, (out,), (fa_mod.attention_plain(*qkv, causal=False),),
                                   dtype_name)
        print(f"[kernel] flash {dtype_name} non-causal (1,2048,32|4,64) {point}: max abs err "
              f"{err:.3e}, row error {row:.3e}")
        if failed:
            errors.append(f"flash {dtype_name} non-causal {point}: {err}, row {row}; {failed}")
    fa_hd = {}  # (dtype, hd, H, KV) -> (fastest point, ms) of the 3a shapes
    for shape in (FLASH_HD80, dict(FLASH_HD80, hd=64), FLASH_HD256):
        for dtype_name in ("bfloat16", "float32"):
            key = (dtype_name, shape["hd"], shape["H"], shape["KV"])
            times = flash_cases[(dtype_name, shape["S"]) + key[1:]][2]
            best = min(times, key=times.get)
            fa_hd[key] = (json.loads(best), times[best])

    # C3: head dims off the kernels' 16-byte rule, padded by the wrapper;
    # the copy's cost: the wrapper's time against the kernel alone on
    # inputs padded beforehand
    c3 = []
    B3, S3, H3, KV3 = (C3_SHAPE[k] for k in ("B", "S", "H", "KV"))
    for dtype_name, hds in C3_HEAD_DIMS:
        for hd in hds:
            qkv = fa_ref.make_inputs(gen, dtype=getattr(torch, dtype_name), device=device,
                                     hd=hd, **C3_SHAPE)
            region = fa_ops.flash_region(S3, hd, dtype_name, arch=arch,
                                         heads=bucket_pow2(B3 * H3))
            err, row, times = sweep(
                torch, f"flash {dtype_name} C3 ({B3},{S3},{H3}|{KV3},{hd})", region,
                lambda p, qkv=qkv: fa_mod.flash_attention_cuda(*qkv, **p),
                (fa_mod.attention_plain(*qkv),), dtype_name, timer, fa_mod.counter, errors,
            )
            best = min(times, key=times.get)
            point, hd_run = json.loads(best), fa_mod.padded_hd(hd, dtype_name)
            padded = [fa_mod.pad_head_dim(t, hd_run) for t in qkv]
            kernel_ms = timer.ms(lambda: fa_mod.flash_attention_cuda(*padded, **point))
            c3.append({"dtype": dtype_name, "hd": hd, "hd_run": hd_run, "heads": f"{H3}|{KV3}",
                       "candidates": len(times), "max_abs_err": err, "max_row_err": row,
                       "fastest_point": point, "ms": times[best],
                       "padded_kernel_ms": kernel_ms, "copy_ms": times[best] - kernel_ms})
            print(f"[kernel] flash {dtype_name} C3 hd {hd} (runs at {hd_run}): {point} "
                  f"{times[best]:.4f} ms, the kernel alone on padded inputs {kernel_ms:.4f} ms, "
                  f"the copy {times[best] - kernel_ms:.4f} ms")
    print(f"[c3] hd 300 raises: {fa_mod.head_dim_error(300, 'bfloat16')}")

    # the flash backward: every emitted point, both dtypes, six shapes
    t0 = time.perf_counter()
    bwd_cases = flash_bwd_phase(torch, fa_mod, fa_ref, fa_ops, arch, timer, optin, errors)
    print(f"[time] flash bwd sweep: {time.perf_counter() - t0:.1f} s")
    # the scans' backward kernels: every emitted point at their shapes
    t0 = time.perf_counter()
    scan_bwd = scan_bwd_phase(torch, arch, timer, optin, errors)
    print(f"[time] scan bwd sweep: {time.perf_counter() - t0:.1f} s")

    st_inp = st_ref.make_inputs(gen, dims=STRESS_DIMS, device=device)
    st_plain_out = outputs(st_mod.stress_plain(st_inp))
    st_region = st_ops.stress_region(dims=STRESS_DIMS, arch=arch)
    st_err, st_row, st_times = sweep(
        torch, "stress f32 (256,256,256)", st_region,
        lambda p: st_mod.stress_cuda(st_inp, **p), st_plain_out, "float32",
        timer, st_mod.counter, errors,
    )

    # the scans, f32 then bf16 (the f32 inputs cast; A, D and lam stay f32)
    ssm_f32 = ssm_ref.make_inputs(gen, device=device, **SSM)
    rg_f32 = rg_ref.make_inputs(gen, device=device, **RGLRU)
    scans = {}  # (name, dtype) -> (args, plain out, region, max err, row err, times)
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        tag = "f32" if dtype == torch.float32 else "bf16"
        tol = SCAN_TOL if dtype == torch.float32 else None
        elt = ssm_mod.DTYPES[dtype]
        x, dt, A, Bc, Cc, Dp = ssm_f32
        args = (x.to(dtype), dt.to(dtype), A, Bc.to(dtype), Cc.to(dtype), Dp)
        region = ssm_ops.ssm_region(SSM["D"], SSM["S"], SSM["N"], SSM["B"], arch=arch,
                                    dtype=dtype_name)
        check_ssm_smem(ssm_mod, region, SSM["N"], dtype, optin, errors)
        plain_out = (ssm_mod.ssm_scan_plain(*args),)
        label = f"ssm_scan {tag} (1,2048,8192,N=16)"
        err, row, times = sweep(
            torch, label, region,
            lambda p, args=args: ssm_mod.ssm_scan_cuda(*args, **p), plain_out, dtype_name,
            timer, ssm_mod.counter, errors, tol=tol,
        )
        scans[("ssm_scan", dtype_name)] = (args, plain_out, region, err, row, times)

        x, r, i, lam = rg_f32
        args = (x.to(dtype), r.to(dtype), i.to(dtype), lam)
        region = rg_ops.rglru_region(RGLRU["W"], RGLRU["S"], RGLRU["B"], arch=arch,
                                     dtype=dtype_name)
        for point in region.space.points():
            model = rg_mod.smem_bytes(point["block_w"], point["chunk"], point["split"], elt)
            native = rg_mod.smem_bytes_native(point["block_w"], point["chunk"],
                                              point["split"], elt)
            if model != native or model > optin:
                errors.append(f"rglru_scan {tag} {point}: smem model {model}, kernel {native}, "
                              f"limit {optin}")
        plain_out = (rg_mod.rglru_scan_plain(*args),)
        label = f"rglru_scan {tag} (1,2048,2560)"
        err, row, times = sweep(
            torch, label, region,
            lambda p, args=args: rg_mod.rglru_scan_cuda(*args, **p), plain_out, dtype_name,
            timer, rg_mod.counter, errors, tol=tol,
        )
        scans[("rglru_scan", dtype_name)] = (args, plain_out, region, err, row, times)

    # the second shape, f32: every point, with a short last trip
    x, dt, A, Bc, Cc, Dp = ssm_ref.make_inputs(gen, device=device, **dict(SSM, **ODD))
    args = (x, dt, A, Bc, Cc, Dp)
    region = ssm_ops.ssm_region(SSM["D"], ODD["S"], SSM["N"], ODD["B"], arch=arch)
    plain_out = (ssm_mod.ssm_scan_plain(*args),)
    err, row, times = sweep(
        torch, f"ssm_scan f32 ({ODD['B']},{ODD['S']},8192,N=16)", region,
        lambda p, args=args: ssm_mod.ssm_scan_cuda(*args, **p), plain_out, "float32",
        timer, ssm_mod.counter, errors, tol=SCAN_TOL,
    )
    scans[("ssm_scan", "odd")] = (args, plain_out, region, err, row, times)
    args = rg_ref.make_inputs(gen, device=device, **dict(RGLRU, **ODD))
    region = rg_ops.rglru_region(RGLRU["W"], ODD["S"], ODD["B"], arch=arch)
    plain_out = (rg_mod.rglru_scan_plain(*args),)
    err, row, times = sweep(
        torch, f"rglru_scan f32 ({ODD['B']},{ODD['S']},2560)", region,
        lambda p, args=args: rg_mod.rglru_scan_cuda(*args, **p), plain_out, "float32",
        timer, rg_mod.counter, errors, tol=SCAN_TOL,
    )
    scans[("rglru_scan", "odd")] = (args, plain_out, region, err, row, times)

    # the ssm_scan final state (a model's prefill hands it to decode): every
    # emitted point of the falcon-mamba-7b shape class, y and h
    args, _, region = scans[("ssm_scan", "float32")][:3]
    final_ref = ssm_mod.ssm_scan_plain(*args, final_state=True)
    fs_err, fs_row = check_points(
        torch, "ssm_scan f32 (1,2048,8192,N=16) with its final state",
        list(region.space.points()),
        lambda p: ssm_mod.ssm_scan_cuda(*args, **p, final_state=True), final_ref, "float32",
        ssm_mod.counter, errors, SCAN_TOL)
    times = scans[("ssm_scan", "float32")][5]
    fs_point = json.loads(min(times, key=times.get))
    # in turns: without, with, with, without
    fs_runs = [(w, timer.ms(lambda w=w: ssm_mod.ssm_scan_cuda(*args, **fs_point, final_state=w),
                            reps=20)) for w in (False, True, True, False)]
    fs_ms = {w: min(ms for v, ms in fs_runs if v == w) for w in (False, True)}
    print(f"[kernel] ssm_scan f32 (1,2048,8192,N=16) at {fs_point}, without / with / with / "
          f"without the final state: " + " / ".join(f"{ms:.4f}" for _, ms in fs_runs) + " ms")

    # short sequences and narrow widths: every emitted point and the extras
    short_err = {"ssm_scan": (0.0, 0.0), "rglru_scan": (0.0, 0.0)}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        tol = SCAN_TOL if dtype == torch.float32 else None
        for shape, extra in SSM_SHORT:
            x, dt, A, Bc, Cc, Dp = ssm_ref.make_inputs(gen, device=device, **shape)
            args = (x.to(dtype), dt.to(dtype), A, Bc.to(dtype), Cc.to(dtype), Dp)
            region = ssm_ops.ssm_region(shape["D"], shape["S"], shape["N"], shape["B"],
                                        arch=arch, dtype=dtype_name)
            got = check_points(
                torch, f"ssm_scan {dtype_name} {tuple(shape.values())}",
                list(region.space.points()) + extra,
                lambda p, args=args: ssm_mod.ssm_scan_cuda(*args, **p),
                (ssm_mod.ssm_scan_plain(*args),), dtype_name, ssm_mod.counter, errors, tol)
            short_err["ssm_scan"] = tuple(map(max, short_err["ssm_scan"], got))
        for shape, extra in RGLRU_SHORT:
            x, r, i, lam = rg_ref.make_inputs(gen, device=device, **shape)
            args = (x.to(dtype), r.to(dtype), i.to(dtype), lam)
            region = rg_ops.rglru_region(shape["W"], shape["S"], shape["B"], arch=arch,
                                         dtype=dtype_name)
            got = check_points(
                torch, f"rglru_scan {dtype_name} {tuple(shape.values())}",
                list(region.space.points()) + extra,
                lambda p, args=args: rg_mod.rglru_scan_cuda(*args, **p),
                (rg_mod.rglru_scan_plain(*args),), dtype_name, rg_mod.counter, errors, tol)
            short_err["rglru_scan"] = tuple(map(max, short_err["rglru_scan"], got))

    # 3b: ssm_scan at state sizes that are no power of two, or past 32
    ssm_states = {}  # (N, dtype) -> (max err, row err, {point: ms})
    for N in SSM_STATES:
        x, dt, A, Bc, Cc, Dp = ssm_ref.make_inputs(gen, device=device, **dict(SSM, N=N))
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            tag = "f32" if dtype == torch.float32 else "bf16"
            args = (x.to(dtype), dt.to(dtype), A, Bc.to(dtype), Cc.to(dtype), Dp)
            region = ssm_ops.ssm_region(SSM["D"], SSM["S"], N, SSM["B"], arch=arch,
                                        dtype=dtype_name)
            check_ssm_smem(ssm_mod, region, N, dtype, optin, errors)
            err, row, times = sweep(
                torch, f"ssm_scan {tag} (1,2048,8192,N={N})", region,
                lambda p, args=args: ssm_mod.ssm_scan_cuda(*args, **p),
                (ssm_mod.ssm_scan_plain(*args),), dtype_name, timer, ssm_mod.counter, errors,
                tol=SCAN_TOL if dtype == torch.float32 else None,
            )
            ssm_states[(N, dtype_name)] = (err, row, times)
    # N = 256 (8 and 16 states a thread), every point on a narrow width, and
    # the shared-memory model at the slice width
    x, dt, A, Bc, Cc, Dp = ssm_ref.make_inputs(gen, device=device, **SSM_N256)
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        args = (x.to(dtype), dt.to(dtype), A, Bc.to(dtype), Cc.to(dtype), Dp)
        region = ssm_ops.ssm_region(SSM_N256["D"], SSM_N256["S"], 256, 1, arch=arch,
                                    dtype=dtype_name)
        got = check_points(
            torch, f"ssm_scan {dtype_name} {tuple(SSM_N256.values())}",
            list(region.space.points()),
            lambda p, args=args: ssm_mod.ssm_scan_cuda(*args, **p),
            (ssm_mod.ssm_scan_plain(*args),), dtype_name, ssm_mod.counter, errors,
            SCAN_TOL if dtype == torch.float32 else None)
        ssm_states[(256, dtype_name)] = got
        check_ssm_smem(ssm_mod, ssm_ops.ssm_region(SSM["D"], SSM["S"], 256, 1, arch=arch,
                                                   dtype=dtype_name),
                       256, dtype, optin, errors)

    # 3c: the apps: every (variant, degree) against the plain body on the card
    app_deg = app_degrees(arch)
    apps = {}  # key -> (nest, inputs, plain out, max err, row err, {point: ms})
    for key, nest, dims in (("gkv", gkv.exb_nest(), gkv.GKV_DIMS),
                            ("seism3d 64^3", seism3d.stress_nest(), seism3d.SEISM_DIMS),
                            ("seism3d 256^3", seism3d.stress_nest(seism3d.CARD_DIMS),
                             seism3d.CARD_DIMS)):
        app = gkv if key == "gkv" else seism3d
        inputs = app.make_inputs(SEED, dims, device=device)
        plain_out = outputs(nest.reference(inputs))
        region = nest.at_region(degrees=app_deg)
        err, row, times = sweep_once(
            torch, f"loop_nest {key} {tuple(nest.lengths)}", region,
            lambda p, r=region, i=inputs: r.candidate(p)(i), plain_out, timer,
            ln_mod.counters[key.split()[0]], errors)
        apps[key] = (nest, inputs, plain_out, err, row, times)

    for (name, dtype_name), (_, _, region, _, _, times) in scans.items():
        for point in region.space.points():  # the hint's rank beside the card's
            hint = region.hints[pp_key(point)]
            print(f"[hint] {name} {dtype_name} {pp_key(point)}: est {hint['est_s'] * 1e3:.4f} ms "
                  f"(latency {hint['latency_s'] * 1e3:.4f}), measured "
                  f"{times[pp_key(point)]:.4f} ms")
    if errors:
        for e in errors:
            print(f"[error] {e}", file=sys.stderr)
        return fail(f"{len(errors)} kernel check(s) failed")

    # -- main path: the registry loop, counts reset before each kernel's ---
    # run and read right after it
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    db_path = str(Path(tmp) / "tuning_db.json")
    qkv, flash_plain, flash_times = flash_cases[("bfloat16", 2048, 64, 32, 4)]
    counters = {"exb": exb_mod.counter, "flash_attention": fa_mod.counter,
                "stress": st_mod.counter, "ssm_scan": ssm_mod.counter,
                "rglru_scan": rg_mod.counter}
    # (key, kernel, args, plain out, dtype, tolerance): the scans' bf16 runs
    # after their f32 ones, each in a shape class of its own
    qkv32, flash32_plain, flash32_times = flash_cases[("float32", 2048, 64, 32, 4)]
    paths = [
        ("exb", "exb", (inp,), exb_plain_out, "float32", None),
        ("flash_attention", "flash_attention", qkv, flash_plain, "bfloat16", None),
        ("flash_attention f32", "flash_attention", qkv32, flash32_plain, "float32", None),
        ("stress", "stress", (st_inp,), st_plain_out, "float32", None),
    ]
    for name in ("ssm_scan", "rglru_scan"):
        for case, key, tol in (("float32", name, SCAN_TOL),
                               ("bfloat16", f"{name} bf16", None),
                               ("odd", f"{name} b4_s2047", SCAN_TOL)):
            args, plain_out = scans[(name, case)][:2]
            dtype_name = "bfloat16" if case == "bfloat16" else "float32"
            paths.append((key, name, args, plain_out, dtype_name, tol))
    states, launches = {}, {}
    for key, name, args, plain, dtype_name, tol in paths:
        for counter in counters.values():
            counter.reset()
        states[key] = main_path(torch, name, args, plain, dtype_name, db_path,
                                errors, tol)
        launches[key] = counters[name].launches
        plain_calls = sum(c.plain_calls for c in counters.values())
        print(f"[main] {key}: launches {launches[key]}, plain-version calls {plain_calls}")
        if launches[key] <= 0 or plain_calls != 0:
            errors.append(f"{key}: main path did not run through its kernel alone")
    for name in ("ssm_scan", "rglru_scan"):
        f32_bp, bf16_bp = states[name][0].bp, states[f"{name} bf16"][0].bp
        print(f"[main] {name}: tuned point f32 {states[name][0].region.selected} | bf16 "
              f"{states[f'{name} bf16'][0].region.selected}")
        if f32_bp.fingerprint() == bf16_bp.fingerprint():
            errors.append(f"{name} bf16: same shape class as f32")
        if states[f"{name} b4_s2047"][0].bp.fingerprint() == f32_bp.fingerprint():
            errors.append(f"{name} B={ODD['B']}, S={ODD['S']}: same shape class as B=1")
    (exb_state, exb_tune_s, exb_recall_s), (fa_state, fa_tune_s, fa_recall_s) = (
        states["exb"], states["flash_attention"])
    f32_state, f32_tune_s, f32_recall_s = states["flash_attention f32"]
    if f32_state.bp.fingerprint() == fa_state.bp.fingerprint():
        errors.append("flash_attention f32: same shape class as bf16")

    # flash at B=4: B·H = 128 is a shape class of its own, tuned and recalled
    qkv4 = fa_ref.make_inputs(gen, dtype=torch.bfloat16, device=device,
                              **dict(FLASH, B=FLASH_B))
    plain4 = (fa_mod.attention_plain(*qkv4),)
    for counter in counters.values():
        counter.reset()
    b4_state, b4_tune_s, b4_recall_s = main_path(
        torch, "flash_attention", qkv4, plain4, "bfloat16", db_path, errors)
    b4_launches = fa_mod.counter.launches
    b4_plain = sum(c.plain_calls for c in counters.values())
    b4_pt = b4_state.region.selected
    print(f"[main] flash_attention B={FLASH_B}: launches {b4_launches}, plain-version calls "
          f"{b4_plain}; heads bucket {fa_state.bp['heads']} -> {b4_state.bp['heads']}; "
          f"tuned point B=1 {fa_state.region.selected} | B={FLASH_B} {b4_pt}")
    if b4_launches <= 0 or b4_plain != 0:
        errors.append(f"flash_attention B={FLASH_B}: main path did not run through its kernel alone")
    if b4_state.bp.fingerprint() == fa_state.bp.fingerprint():
        errors.append(f"flash_attention B={FLASH_B}: same shape class as B=1")

    # flash at hd 256 (recurrentgemma-2b) in bf16: a shape class of its own
    qkv256, plain256, times256 = flash_cases[("bfloat16", 2048, 256, 10, 1)]
    for counter in counters.values():
        counter.reset()
    hd256_state, hd256_tune_s, hd256_recall_s = main_path(
        torch, "flash_attention", qkv256, plain256, "bfloat16", db_path, errors)
    launches["flash_attention hd256"] = fa_mod.counter.launches
    hd256_plain = sum(c.plain_calls for c in counters.values())
    hd256_pt = hd256_state.region.selected
    print(f"[main] flash_attention hd 256: launches {fa_mod.counter.launches}, plain-version "
          f"calls {hd256_plain}; tuned point {hd256_pt}, "
          f"{times256[pp_key(hd256_pt)]:.4f} ms in the sweep")
    if fa_mod.counter.launches <= 0 or hd256_plain != 0:
        errors.append("flash_attention hd 256: main path did not run through its kernel alone")
    q256, k256, v256 = (t.transpose(1, 2) for t in qkv256)
    hd256_sdpa_ms = timer.ms(lambda: F.scaled_dot_product_attention(
        q256, k256, v256, is_causal=True, enable_gqa=True))
    print(f"[main] flash_attention hd 256: the tuned point {times256[pp_key(hd256_pt)]:.4f} ms "
          f"in the sweep, SDPA's forward {hd256_sdpa_ms:.4f} ms")

    # the flash backward's tinyllama class of each dtype: tuned, recalled, timed
    bwd_main = flash_bwd_main(torch, F, fa_mod, fa_ref, arch, timer, bwd_cases, db_path, errors)
    del bwd_cases
    torch.cuda.empty_cache()

    # the apps: each region tuned cold through the Tuner (GKV's as Figs.
    # 13-14), recalled from a fresh TuningDB with nothing measured, the
    # recalled point run and checked; then Fig. 12 on Seism3D at 256^3
    every = list(counters.values()) + list(ln_mod.counters.values())
    app_main = {}
    for name, key in (("gkv", "gkv"), ("seism3d", "seism3d 256^3")):
        nest, inputs, plain_out = apps[key][:3]
        app_db = str(Path(tmp) / f"{name}_db.json")
        for counter in every:
            counter.reset()
        t0 = time.perf_counter()
        if name == "gkv":
            f13 = paper_figures.fig13_14(nest, inputs, app_deg, TuningDB(app_db), arch)
            tuned, evaluations = f13["best_point"], f13["evaluations"]
        else:
            result, _, _ = paper_figures.tune(nest, inputs, app_deg, TuningDB(app_db), arch)
            tuned, evaluations = result.best.point, result.evaluations
        tune_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        point, region = paper_figures.recall(nest, app_deg, app_db, device)
        recall_s = time.perf_counter() - t0
        out = region(inputs)
        torch.cuda.synchronize()
        err, row, failed = max_err(torch, outputs(out), plain_out, "float32")
        if name == "seism3d":
            f12 = paper_figures.fig12(nest, inputs, calls=50)
        launches[f"loop_nest_{name}"] = ln_mod.counters[name].launches
        plain_calls = sum(c.plain_calls for c in every)
        print(f"[main] loop_nest {key}: cold tune, {evaluations} evaluations, winner {tuned}, "
              f"{tune_s:.3f} s; fresh TuningDB recalls {point} in {recall_s:.3f} s with 0 "
              f"evaluations; its output vs plain: max abs err {err:.3e}, row error {row:.3e}; "
              f"launches {launches[f'loop_nest_{name}']}, plain-version calls {plain_calls}")
        if evaluations <= 0 or point is None or pp_key(point) != pp_key(tuned) or failed:
            errors.append(f"loop_nest {key}: tune {evaluations} evaluations, recall {point} "
                          f"for {tuned}, output {failed}")
        if launches[f"loop_nest_{name}"] <= 0 or plain_calls != 0:
            errors.append(f"loop_nest {key}: main path did not run through its kernel alone")
        app_main[name] = dict(point=tuned, evaluations=evaluations, tune_s=tune_s,
                              recall_s=recall_s, region=region, key=key)

    # the figures beside the paper's
    f11 = paper_figures.fig11(apps["gkv"][0], apps["gkv"][1], arch=arch)
    for r in f11["rows"]:
        print(f"[fig11] {r['figure']} {r['variant']}: {r['s'] * 1e3:.4f} ms at degree 32, "
              f"{r['launches']} launches of {r['ctas']} CTAs, {r['speedup']:.3f}x the original")
    print(f"[fig11] best {f11['best']['figure']}: {f11['best']['speedup']:.3f}x the original "
          f"(paper FX100: directive on the outermost loop, {f11['paper']}x)")
    print(f"[fig12] seism3d 256^3 variant (3,1): degree 8 fixed {f12['fixed_s'] * 1e3:.4f} ms, "
          f"switched every call {f12['switch_s'] * 1e3:.4f} ms ({f12['switches']} switches "
          f"over {f12['calls']} calls): ratio {f12['ratio']:.4f} (paper <= {f12['paper']}); "
          f"degree 32 fixed {f12['full_s'] * 1e3:.4f} ms, ratio to it "
          f"{f12['ratio_vs_full']:.4f}")
    for r in f13["rows"]:
        print(f"[fig13] {r['figure']} {r['variant']}: best degree {r['best_degree']}, "
              f"{r['s'] * 1e3:.4f} ms, {r['fig13']:.3f}x the original at degree 32")
        print(f"[fig14] {r['figure']} {r['variant']}: {r['s_at_32'] * 1e3:.4f} ms at degree 32, "
              f"best degree {r['best_degree']} {r['fig14']:.3f}x faster")
    inner = next(r for r in f13["rows"] if r["variant"] == (4, 4))
    print(f"[fig13] combined best {f13['best_point']}: {f13['combined']:.3f}x the original at "
          f"degree 32 (paper FX100: {f13['paper']['fig13']}x)")
    print(f"[fig14] innermost directive: best degree {inner['best_degree']}, "
          f"{inner['fig14']:.3f}x against degree 32 (paper FX100: "
          f"{f13['paper']['fig14_innermost']}x at 1 thread against 32)")

    # exb: staged winner against one exhaustive search (every emitted point)
    ex_db = str(Path(tmp) / "exhaustive_db.json")
    ex_op = autotuned("exb", db=TuningDB(ex_db), search=ExhaustiveSearch())
    ex_op(inp)
    ex_state = ex_op.resolve(inp)
    staged_pt, ex_pt = exb_state.region.selected, ex_state.region.selected
    staged_ms = timer.ms(lambda: exb_mod.exb_cuda(inp, **staged_pt), reps=20)
    ex_ms = timer.ms(lambda: exb_mod.exb_cuda(inp, **ex_pt), reps=20)
    within = staged_ms <= 1.05 * ex_ms
    print(f"[main] exb exhaustive: {ex_state.cost_evaluations} evaluations, winner "
          f"{ex_pt} {ex_ms:.4f} ms; staged winner {staged_pt} {staged_ms:.4f} ms; "
          f"staged within 5%: {within}")
    swept = {"flash_attention": flash_times, "flash_attention f32": flash32_times,
             "stress": st_times}
    for name in ("ssm_scan", "rglru_scan"):
        swept[name] = scans[(name, "float32")][5]
        swept[f"{name} bf16"] = scans[(name, "bfloat16")][5]
        swept[f"{name} b4_s2047"] = scans[(name, "odd")][5]
    fastest = {}
    for name, times in swept.items():
        point = states[name][0].region.selected
        fastest[name] = min(times, key=times.get)
        print(f"[main] {name}: staged winner {point} "
              f"{times[pp_key(point)]:.4f} ms in the sweep; fastest swept "
              f"{fastest[name]} {times[fastest[name]]:.4f} ms; within 10%: "
              f"{times[pp_key(point)] <= 1.1 * times[fastest[name]]}")
    fa_pt = fa_state.region.selected
    fa_best = fastest["flash_attention"]
    f32_pt, f32_best = f32_state.region.selected, fastest["flash_attention f32"]
    if flash32_times[pp_key(f32_pt)] > 1.1 * flash32_times[f32_best]:
        errors.append(f"flash_attention f32: staged winner {f32_pt} "
                      f"{flash32_times[pp_key(f32_pt)]:.4f} ms, more than 10% over the "
                      f"fastest swept {f32_best} {flash32_times[f32_best]:.4f} ms")
    if errors:
        for e in errors:
            print(f"[error] {e}", file=sys.stderr)
        return fail(f"{len(errors)} main-path check(s) failed")

    # -- the model zoo: the serving entry points on the kernels -------------
    # the registry's ops share the kernel phases' TuningDB, so the model path
    # recalls the shape classes they tuned
    from repro_torch.core import REGISTRY

    REGISTRY.set_default_db(TuningDB(db_path))
    tuned_fps = {st.bp.fingerprint() for st, _, _ in states.values()}
    tuned_fps |= {b4_state.bp.fingerprint(), hd256_state.bp.fingerprint()}
    model_counters = {"flash_attention": fa_mod.counter, "ssm_scan": ssm_mod.counter,
                      "rglru_scan": rg_mod.counter}
    t0 = time.perf_counter()
    models = [model_phase(torch, name, depth, steps, device, arch, model_counters, tuned_fps,
                          errors)
              for name, depth, steps in MODELS]
    smoke = smoke_sweep(torch, device, errors)
    print(f"[time] model phases: {time.perf_counter() - t0:.1f} s")
    if errors:
        for e in errors:
            print(f"[error] {e}", file=sys.stderr)
        return fail(f"{len(errors)} model check(s) failed")
    print(json.dumps({"models": models, "smoke_worst_row": smoke}, default=str))

    # -- the serving slice: Server and StreamingEngine on the kernels -------
    t0 = time.perf_counter()
    serve = serve_phases(torch, device, arch, model_counters, errors)
    print(f"[time] serve phases: {time.perf_counter() - t0:.1f} s")
    if errors:
        for e in errors:
            print(f"[error] {e}", file=sys.stderr)
        return fail(f"{len(errors)} serve check(s) failed")
    print(json.dumps({"serve": serve}, default=str))

    # -- the fleet slice: sharded search, service, drift, observe, example ---
    t0 = time.perf_counter()
    fleet = fleet_phases(torch, device, errors)
    print(f"[time] fleet phases: {time.perf_counter() - t0:.1f} s")
    if errors:
        for e in errors:
            print(f"[error] {e}", file=sys.stderr)
        return fail(f"{len(errors)} fleet check(s) failed")
    print(json.dumps({"fleet": fleet}, default=str))

    print(json.dumps({"train": train}, default=str))
    print(json.dumps({"dryrun": dryrun}, default=str))

    # -- the kernels line --------------------------------------------------
    iv, iz, mx, my = EXB_DIMS
    exb_bytes = 4.0 * (6 * iv * iz * mx * my + 8 * iz * mx * my + iv)
    exb_flops = 24.0 * iv * iz * mx * my
    exb_bound = max(exb_bytes / arch.hbm_bandwidth, exb_flops / arch.peak_flops_fp32)
    B, S, H, KV, hd = (FLASH[k] for k in ("B", "S", "H", "KV", "hd"))
    fa_flops = 4.0 * B * H * S * S * hd / 2  # causal: half the square
    fa_bytes = 2.0 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    fa_bound = max(fa_flops / arch.peak_flops, fa_bytes / arch.hbm_bandwidth)
    # f32: three TF32 products a multiply-add on the tensor cores
    f32_ops, f32_bytes = 3 * fa_flops / arch.peak_flops_tf32, 2 * fa_bytes / arch.hbm_bandwidth
    q, k, v = qkv
    qt, kt, vt = (t.transpose(1, 2) for t in qkv)
    # SDPA in f32 on its memory-efficient kernel (3xTF32 on sm80+), K and V
    # expanded to the query heads before the timed call (enable_gqa may
    # steer it to the math backend)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q32t = qkv32[0].transpose(1, 2)
    k32t, v32t = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2) for t in qkv32[1:])
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        f32_library_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            q32t, k32t, v32t, is_causal=True))
    print(f"[library] flash f32: scaled_dot_product_attention on "
          f"{SDPBackend.EFFICIENT_ATTENTION.name} {f32_library_ms:.4f} ms")
    kernels = [
        {
            "name": "exb", "route": "cuda", "source": "src/repro_torch/csrc/exb.cu",
            "replaces": "src/repro/kernels/exb/exb.py:34",
            "launches": launches["exb"], "max_abs_err": exb_err, "max_row_err": exb_row,
            "ms": staged_ms,
            "plain_ms": timer.ms(lambda: exb_mod.exb_plain(inp)),
            "bound_ms": exb_bound * 1e3,
            "bound_by": "bytes" if exb_bytes / arch.hbm_bandwidth
            >= exb_flops / arch.peak_flops_fp32 else "operations",
            "library_ms": None,
            "candidates": len(exb_times), "tuned_point": staged_pt,
            "exhaustive_point": ex_pt, "exhaustive_ms": ex_ms,
            "tune_s": exb_tune_s, "recall_s": exb_recall_s,
        },
        {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
            "f32_source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/flash_attention.py:29",
            "launches": launches["flash_attention"], "max_abs_err": fa_err,
            "max_row_err": fa_row,
            "ms": timer.ms(lambda: fa_mod.flash_attention_cuda(q, k, v, **fa_pt)),
            "plain_ms": timer.ms(lambda: fa_mod.attention_plain(q, k, v)),
            "bound_ms": fa_bound * 1e3,
            "bound_by": "operations" if fa_flops / arch.peak_flops
            >= fa_bytes / arch.hbm_bandwidth else "bytes",
            "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            "candidates": sum(len(c[2]) for c in flash_cases.values()),
            "tuned_point": fa_pt, "fastest_swept_point": json.loads(fa_best),
            "fastest_swept_ms": flash_times[fa_best],
            "instantiations": len(sm90), "spill_bytes": fa_spill,
            "tune_s": fa_tune_s, "recall_s": fa_recall_s,
            f"b{FLASH_B}_tuned_point": b4_pt, f"b{FLASH_B}_launches": b4_launches,
            f"b{FLASH_B}_ms": timer.ms(lambda: fa_mod.flash_attention_cuda(*qkv4, **b4_pt)),
            f"b{FLASH_B}_tune_s": b4_tune_s, f"b{FLASH_B}_recall_s": b4_recall_s,
            "f32_ms": timer.ms(lambda: fa_mod.flash_attention_cuda(*qkv32, **f32_pt), reps=20),
            "f32_bound_ms": max(f32_ops, f32_bytes) * 1e3,
            "f32_bound_by": "operations (3xTF32)" if f32_ops >= f32_bytes else "bytes",
            "f32_cuda_core_floor_ms": fa_flops / arch.peak_flops_fp32 * 1e3,
            "f32_plain_ms": timer.ms(lambda: fa_mod.attention_plain(*qkv32), reps=5),
            "f32_library_ms": f32_library_ms,
            "f32_tuned_point": f32_pt, "f32_launches": launches["flash_attention f32"],
            "f32_fastest_swept_point": json.loads(f32_best),
            "f32_fastest_swept_ms": flash32_times[f32_best],
            "f32_candidates": len(flash32_times),
            "f32_instantiations": len(flash_tiles["f32"]),
            "f32_tune_s": f32_tune_s, "f32_recall_s": f32_recall_s,
            "lse_ms": timer.ms(lambda: fa_mod.flash_attention_cuda(q, k, v, **fa_pt,
                                                                   return_lse=True)),
            "f32_lse_ms": timer.ms(lambda: fa_mod.flash_attention_cuda(
                *qkv32, **f32_pt, return_lse=True), reps=20),
            "train_launches": train["tinyllama"]["flash_launches"],
        },
        {
            "name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
            "hd256_source": "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
            "f32_source": "src/repro_torch/csrc/flash_attention_bwd_f32.cu",
            "replaces": "src/repro/models/attention.py:260",
            "launches": train["tinyllama"]["flash_bwd_launches"],
            "train_launches": train["tinyllama"]["flash_bwd_launches"],
            "max_abs_err": bwd_main["bfloat16"]["max_abs_err"],
            "max_row_err": bwd_main["bfloat16"]["max_row_err"],
            "ms": bwd_main["bfloat16"]["ms"], "plain_ms": bwd_main["bfloat16"]["plain_ms"],
            "bound_ms": bwd_main["bfloat16"]["bound_ms"],
            "bound_by": bwd_main["bfloat16"]["bound_by"],
            "library_ms": bwd_main["bfloat16"]["sdpa_bwd_ms"],
            "sdpa_bwd_ms": bwd_main["bfloat16"]["sdpa_bwd_ms"],
            "shape": FLASH_BWD, **{k: v for k, v in bwd_main["bfloat16"].items()
                                   if k not in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "sdpa_bwd_ms", "max_abs_err", "max_row_err")},
            **{f"b4_{k}": v for k, v in bwd_main["bfloat16_b4"].items()},
            **{f"f32_{k}": v for k, v in bwd_main["float32"].items()},
            **{f"hd256_{k}": v for k, v in bwd_main["bfloat16_hd256"].items()},
            **{f"f32_hd256_{k}": v for k, v in bwd_main["float32_hd256"].items()},
            "recurrentgemma_train_launches":
                train["recurrentgemma-2b"]["launches"]["flash_attention"][1],
        },
    ]
    # the scans' backward kernels at their [train] phases' shapes, float32
    # (the models' scans run in float32): the point the Trainer tuned, its
    # time in this run's sweep, the bound, the plain backward's time
    from repro_torch.kernels.rglru_scan import ref as rg_ref_mod
    from repro_torch.kernels.ssm_scan import ref as ssm_ref_mod

    bwd_gen = torch.Generator(device=device).manual_seed(SEED + 22)
    for name, source, arch_name, tag in (
            ("ssm_scan", "ssm_scan_bwd.cu", "falcon-mamba-7b", "(2,2048,8192,N=16)"),
            ("rglru_scan", "rglru_scan_bwd.cu", "recurrentgemma-2b", "(1,2048,2560)")):
        run_ = train[arch_name]
        case = scan_bwd[(name, "float32", tag)]
        point = next(c["point"] for c in run_["kernel_classes"] if c["kernel"] == f"{name}_bwd")
        shape = case["shape"]
        if name == "ssm_scan":
            x, dt, A, Bc, Cc, Dp = ssm_ref_mod.make_inputs(bwd_gen, device=device, **shape)
            args = (x, dt, A, Bc, Cc, Dp, torch.randn_like(x), None)
            plain = ssm_mod.ssm_scan_bwd_plain
            replaces = "src/repro/models/ssm.py:95"
        else:
            x, r, i, lam = rg_ref_mod.make_inputs(bwd_gen, device=device, **shape)
            args = (x, r, i, lam, torch.randn_like(x))
            plain = rg_mod.rglru_scan_bwd_plain
            replaces = "src/repro/models/rglru.py:82"
        scan_cases = [c for (n, _, _), c in scan_bwd.items() if n == name]
        bf16 = scan_bwd[(name, "bfloat16", tag.replace("(2,", "(1,"))]
        kernels.append({
            "name": f"{name}_bwd", "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "replaces": replaces,
            "launches": run_["launches"][name][1],
            "max_abs_err": max(c["max_abs_err"] for c in scan_cases),
            "max_row_err": max(c["max_row_err"] for c in scan_cases),
            "ms": case["times"][pp_key(point)],
            "plain_ms": timer.ms(lambda: plain(*args), reps=1),
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "library_ms": None,  # no single PyTorch call computes it
            "shape": shape, "dtype": "float32", "tuned_point": point,
            "sfu_floor_ms": case["sfu_ms"], "candidates": case["candidates"],
            "fastest_swept_point": case["fastest_point"], "fastest_swept_ms": case["fastest_ms"],
            "forward_point": case["forward_point"], "forward_ms": case["forward_ms"],
            "launches_a_step": run_["launches_a_step"][name][1],
            "bf16_fastest_ms": bf16["fastest_ms"], "bf16_bound_ms": bf16["bound_ms"],
            "bf16_forward_ms": bf16["forward_ms"],
            "shapes": [{"shape": c["shape"], "dtype": c["dtype"], "fastest_point": c["fastest_point"],
                        "ms": c["fastest_ms"], "bound_ms": c["bound_ms"],
                        "forward_ms": c["forward_ms"], "max_abs_err": c["max_abs_err"],
                        "max_row_err": c["max_row_err"]} for c in scan_cases],
        })
        del args
    # stress and the scans: (name, source, TPU kernel, kernel, plain version, args,
    # (flops, bytes) of the call, max errors, swept times)
    ssm_args, _, _, ssm_err, ssm_row, ssm_times = scans[("ssm_scan", "float32")]
    rg_args, _, _, rg_err, rg_row, rg_times = scans[("rglru_scan", "float32")]
    slice_two = (
        ("stress", "stress.cu", "stress/stress.py:19", st_mod.stress_cuda,
         st_mod.stress_plain, (st_inp,), st_mod.traffic(*STRESS_DIMS),
         (st_err, st_row), st_times),
        ("ssm_scan", "ssm_scan.cu", "ssm_scan/ssm_scan.py:23", ssm_mod.ssm_scan_cuda,
         ssm_mod.ssm_scan_plain, ssm_args, ssm_mod.traffic(**SSM),
         (ssm_err, ssm_row), ssm_times),
        ("rglru_scan", "rglru_scan.cu", "rglru_scan/rglru_scan.py:18",
         rg_mod.rglru_scan_cuda, rg_mod.rglru_scan_plain, rg_args,
         rg_mod.traffic(*(RGLRU[k] for k in ("B", "S", "W"))),
         (rg_err, rg_row), rg_times),
    )
    for name, source, replaces, kernel, plain, args, (flops, bytes_), (err, row), times in slice_two:
        state, tune_s, recall_s = states[name]
        point = state.region.selected
        by_bytes, by_ops = bytes_ / arch.hbm_bandwidth, flops / arch.peak_flops_fp32
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": launches[name], "max_abs_err": err, "max_row_err": row,
            "ms": timer.ms(lambda: kernel(*args, **point), reps=20),
            "plain_ms": timer.ms(lambda: plain(*args), reps=5),
            "bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None,  # no single PyTorch call computes it
            "candidates": len(times), "tuned_point": point,
            "fastest_swept_point": json.loads(fastest[name]),
            "fastest_swept_ms": times[fastest[name]],
            "tune_s": tune_s, "recall_s": recall_s,
        })
    # the scans in bf16: the bf16 main path's tuned point, time and bound
    bf16_traffic = {"ssm_scan": ssm_mod.traffic(**SSM, elt=2),
                    "rglru_scan": rg_mod.traffic(*(RGLRU[k] for k in ("B", "S", "W")), elt=2)}
    for entry in kernels:
        name = entry["name"]
        if name not in bf16_traffic:
            continue
        key = f"{name} bf16"
        args, _, _, err, row, times = scans[(name, "bfloat16")]
        state, tune_s, recall_s = states[key]
        point = state.region.selected
        kernel = ssm_mod.ssm_scan_cuda if name == "ssm_scan" else rg_mod.rglru_scan_cuda
        flops, bytes_ = bf16_traffic[name]
        entry.update({
            "bf16_ms": timer.ms(lambda: kernel(*args, **point), reps=20),
            "bf16_bound_ms": max(bytes_ / arch.hbm_bandwidth,
                                 flops / arch.peak_flops_fp32) * 1e3,
            "bf16_tuned_point": point, "bf16_launches": launches[key],
            "bf16_max_abs_err": err, "bf16_max_row_err": row,
            "bf16_candidates": len(times),
            "bf16_fastest_swept_point": json.loads(fastest[key]),
            "bf16_fastest_swept_ms": times[fastest[key]],
            "bf16_tune_s": tune_s, "bf16_recall_s": recall_s,
        })
        key = f"{name} b4_s2047"
        args, _, _, err, row, times = scans[(name, "odd")]
        state, tune_s, recall_s = states[key]
        point = state.region.selected
        entry.update({
            "b4_s2047_ms": timer.ms(lambda: kernel(*args, **point), reps=20),
            "b4_s2047_tuned_point": point, "b4_s2047_launches": launches[key],
            "b4_s2047_max_abs_err": err, "b4_s2047_max_row_err": row,
            "b4_s2047_candidates": len(times),
            "b4_s2047_staged_swept_ms": times[pp_key(point)],
            "b4_s2047_fastest_swept_point": json.loads(fastest[key]),
            "b4_s2047_fastest_swept_ms": times[fastest[key]],
            "short_max_abs_err": short_err[name][0], "short_max_row_err": short_err[name][1],
        })
        if name == "ssm_scan":
            entry["sfu_floor_ms"] = ssm_mod.sfu_seconds(
                SSM["B"], SSM["S"], SSM["D"], SSM["N"], arch.peak_flops_fp32) * 1e3
    # flash at the 3a head dims and its hd-256 main path
    def flash_bound_ms(B, S, H, KV, hd, dtype_name):
        flops = 4.0 * B * H * S * S * hd / 2  # causal: half the square
        elt = 2 if dtype_name == "bfloat16" else 4
        ops = (flops / arch.peak_flops if elt == 2 else 3 * flops / arch.peak_flops_tf32)
        return max(ops, elt * 2.0 * B * S * (H + KV) * hd / arch.hbm_bandwidth) * 1e3

    by_name = {entry["name"]: entry for entry in kernels}
    by_name["flash_attention"].update({
        "head_dims": [
            {"dtype": dtype_name, "hd": hd, "heads": f"{H}|{KV}", "fastest_swept_point": point,
             "ms": ms, "bound_ms": flash_bound_ms(1, 2048, H, KV, hd, dtype_name)}
            for (dtype_name, hd, H, KV), (point, ms) in fa_hd.items()],
        "hd256_tuned_point": hd256_pt, "hd256_launches": launches["flash_attention hd256"],
        "hd256_ms": timer.ms(lambda: fa_mod.flash_attention_cuda(*qkv256, **hd256_pt)),
        "hd256_bound_ms": flash_bound_ms(**FLASH_HD256, dtype_name="bfloat16"),
        "hd256_library_ms": hd256_sdpa_ms,
        "hd256_tune_s": hd256_tune_s, "hd256_recall_s": hd256_recall_s,
    })
    # ssm_scan at the 3b state sizes
    states_rows = []
    for (N, dtype_name), got in ssm_states.items():
        if N == 256:
            states_rows.append({"N": N, "dtype": dtype_name, "shape": SSM_N256,
                                "max_abs_err": got[0], "max_row_err": got[1]})
            continue
        err, row, times = got
        flops, bytes_ = ssm_mod.traffic(SSM["B"], SSM["S"], SSM["D"], N,
                                        elt=2 if dtype_name == "bfloat16" else 4)
        best = min(times, key=times.get)
        states_rows.append({
            "N": N, "dtype": dtype_name, "fastest_swept_point": json.loads(best),
            "ms": times[best], "candidates": len(times), "max_abs_err": err, "max_row_err": row,
            "bound_ms": max(bytes_ / arch.hbm_bandwidth, flops / arch.peak_flops_fp32) * 1e3})
    by_name["ssm_scan"]["state_sizes"] = states_rows
    # the apps' loop-nest kernel: the tuned point of each region
    for name, app in (("gkv", gkv), ("seism3d", seism3d)):
        main = app_main[name]
        nest, inputs, _, err, row, times = apps[main["key"]]
        if name == "seism3d":  # the check covers both grids
            err, row = max(err, apps["seism3d 64^3"][3]), max(row, apps["seism3d 64^3"][4])
        point = main["point"]
        shape = launch_shape(nest.lengths, ExchangeVariant(*point["variant"]), point["degree"])
        n = math.prod(nest.lengths)
        by_bytes = n * app.bytes_per_point() / arch.hbm_bandwidth
        by_ops = n * app.flops_per_point() / arch.peak_flops_fp32
        fastest = min(times, key=times.get)
        run = main["region"].candidate(point)
        kernels.append({
            "name": f"loop_nest_{name}", "route": "cuda",
            "source": "src/repro_torch/csrc/loop_nest.cu",
            "replaces": "src/repro/core/exchange.py:135",
            "launches": launches[f"loop_nest_{name}"], "max_abs_err": err, "max_row_err": row,
            "ms": timer.ms(lambda: run(inputs)),
            "plain_ms": timer.ms(lambda: nest.reference(inputs), reps=5),
            "bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None,  # no single PyTorch call computes the body
            "domain": nest.lengths, "tuned_point": point, "outer_launches": shape.launches,
            "ctas": shape.ctas,
            "candidates": len(times), "evaluations": main["evaluations"],
            "fastest_swept_point": json.loads(fastest), "fastest_swept_ms": times[fastest],
            "tune_s": main["tune_s"], "recall_s": main["recall_s"],
        })
    by_name = {entry["name"]: entry for entry in kernels}
    seism64 = apps["seism3d 64^3"][5]
    best64 = min(seism64, key=seism64.get)
    by_name["loop_nest_seism3d"].update({
        "fig12": {k: v for k, v in f12.items()},
        "seism3d_64_fastest_swept_point": json.loads(best64),
        "seism3d_64_fastest_swept_ms": seism64[best64],
    })
    by_name["loop_nest_gkv"].update({
        "fig11_best": f11["best"], "fig13_combined": f13["combined"],
        "fig14_innermost": inner["fig14"], "fig14_innermost_best_degree": inner["best_degree"],
    })
    # the model path's launches a prefill, and the kernels' new cases
    for entry in kernels:
        if entry["name"] in KERNEL_ENTRIES:
            entry["model_launches"] = {m["arch"]: m["launches"][entry["name"]] for m in models
                                       if m["launches"][entry["name"]]}
    for entry in kernels:
        if entry["name"] in KERNEL_ENTRIES:
            entry["serve_launches"] = {r["run"]: r["launches"][entry["name"]]
                                       for r in serve["runs"] if r["launches"][entry["name"]]}
            entry["serve_trial_launches"] = {
                r["run"]: r["trial_launches"][entry["name"]]
                for r in serve["runs"] if r["trial_launches"][entry["name"]]}
    by_name["flash_attention"]["c3"] = c3
    for name in ("flash_attention", "exb"):
        by_name[name]["fleet_launches"] = {
            str(w): r["launches"] for w, r in fleet["fleet"][name]["runs"].items()}
    by_name["exb"]["service_launches"] = [h["launches"] for h in fleet["service"]["hosts"]]
    by_name["exb"]["drift_launches"] = fleet["drift"]["launches"]
    by_name["ssm_scan"].update({"final_state_max_abs_err": fs_err,
                                "final_state_max_row_err": fs_row, "final_state_point": fs_point,
                                "final_state_ms": fs_ms[True],
                                "without_final_state_ms": fs_ms[False]})
    print(f"[time] chip_smoke: {time.perf_counter() - started:.1f} s to the kernels line, "
          f"the build included")
    print(json.dumps({"kernels": kernels}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
