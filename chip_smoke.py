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
  sharing the kernel phases' TuningDB; and every arch at its SMOKE config.

Phases, each of which fails the run:

1. the card: name and power limit as ``nvidia-smi`` prints them;
2. build: every CUDA source compiled with nvcc, all at once (build time,
   registers and spills; every flash instantiation, bf16 and f32, and
   every scan instantiation must not spill);
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
   port's CPU run on the same weights (worst row within 4·2⁻⁸).

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
also give ``model_launches`` (a prefill's, per model), flash its ``c3``
rows and ``ssm_scan`` its final state's errors.  A ``{"models": ...}``
line before it holds the model phases' records.  The last line is
``{"ok": true, "device": {...}}``.  The script exits non-zero, and prints
no result, without a CUDA card or without the repository beside it.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import tempfile
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
    """Bytes one decode step must move at ``ctx`` cached positions: every
    weight once (the embedding table only where it is also the unembedding:
    a lookup gathers one row), the K/V positions attended, and each
    recurrent state read and written."""
    n = tm.count_params(tm.param_specs(cfg))
    weights = 2.0 * (n - (0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model))
    kinds = model_kernels(cfg)
    kv = 2.0 * 2 * cfg.n_kv_heads * cfg.head_dim_ * kinds["flash_attention"]
    if cfg.family == "hybrid":
        kv *= min(ctx, cfg.local_window)
    else:
        kv *= ctx
    state = 0.0
    if cfg.family == "ssm":
        state = cfg.n_layers * 2 * (4.0 * cfg.d_inner * cfg.ssm_state
                                    + 2.0 * (cfg.d_conv - 1) * cfg.d_inner)
    elif cfg.family == "hybrid":
        state = kinds["rglru_scan"] * 2 * (4.0 * cfg.lru_width_
                                           + 2.0 * (cfg.d_conv - 1) * cfg.lru_width_)
    return weights + kv + state


def kernel_share(torch, fn) -> tuple:
    """(device ms of the hand-written kernels, device ms of everything, the
    eight entries with the most device time as (name, ms)) in one
    ``torch.profiler`` run of ``fn``; (None, None, []) if it saw no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ours = total = 0.0
    rows = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue  # a host op: its kernels are rows of their own
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0.0)
        total += t
        rows.append((evt.key[:80], t / 1e3))
        if any(name in evt.key for names in KERNEL_ENTRIES.values() for name in names):
            ours += t
    if total <= 0:
        return None, None, []
    return ours / 1e3, total / 1e3, sorted(rows, key=lambda r: -r[1])[:8]


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
    the same inputs afterwards."""

    def __init__(self):
        self.calls = []
        self._patches = []

    def __enter__(self):
        from repro_torch.models import encdec, rglru, ssm, transformer

        for module, name in ((transformer, "causal_attention"), (encdec, "causal_attention"),
                             (ssm, "selective_scan"), (rglru, "lru_scan")):
            fn = getattr(module, name)
            self._patches.append((module, name, fn))

            def record(*args, _fn=fn, _name=name, **kwargs):
                out = _fn(*args, **kwargs)
                self.calls.append((_name, args, kwargs, out))
                return out

            setattr(module, name, record)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._patches:
            setattr(module, name, fn)
        return False


def check_calls(torch, label, calls, errors) -> dict:
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
        print(f"[model] {label}: {n} {name} calls of a prefill against the plain version on "
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


def main_path(torch, name, args, plain_out, dtype, db_path, errors, tol=None):
    """Cold tune, fresh-op recall, fast path; returns the cold op's state
    and the host seconds of the cold call and of the recalling call."""
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
    err, row, failed = max_err(torch, outputs(out), plain_out, dtype, tol)
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

    t0 = time.perf_counter()
    for name in _build.sources():
        _build.library(name)
    print(f"[build] {sorted(_build.sources())} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s)")
    logs = sorted(_build.build_dir().glob("*/*.log"), key=lambda p: p.stat().st_mtime)
    for log in logs[-len(_build.sources()):]:
        if log.stem in ("flash_attention", "flash_attention_sm90", "ssm_scan", "rglru_scan"):
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
        for name, entry in ptxas_entries(log).items():
            tile = re.search(kernel + r"ILi(\d+)ELi(\d+)ELi(\d+)E", name)
            if tile:
                tiles[tuple(map(int, tile.groups()))] = entry
        long_name = "bfloat16" if dtype_name == "bf16" else "float32"
        for (hd, bq, bkv), (regs, spill) in sorted(tiles.items()):
            print(f"[ptxas] flash {dtype_name} (hd={hd}, {bq}, {bkv}): {regs} registers, "
                  f"{spill} B spilled, {fa_mod.ctas_per_sm(hd, bq, bkv, long_name)} CTAs/SM")
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
    optin = fa_mod.smem_optin(device)
    if optin < arch.smem_per_block:
        return fail(f"arch plans {arch.smem_per_block} B of shared memory, card allows {optin}")

    errors: list = []
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
        },
    ]
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
    by_name["flash_attention"]["c3"] = c3
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
