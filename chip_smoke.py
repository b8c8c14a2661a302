#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

The main path is the registry autotuning loop, ``autotuned(name)(*args)``:
shape class → TuningDB lookup → candidate space emitted from the card's
ArchSpec → staged search (hint prescreen, then finals timed on the card)
→ ``record_best`` → zero-evaluation recall and the dispatch fast path.  It
runs for both ported kernels at real sizes:

* ``exb`` at the paper's GKV domain (iv, iz, mx, my) = (16, 16, 128, 65), f32;
* ``flash_attention`` at tinyllama-1.1b's attention width (32 query heads,
  4 KV heads, head_dim 64), B=1, S=2048, bf16.

Phases, each of which fails the run:

1. the card: name and power limit as ``nvidia-smi`` prints them;
2. build: both CUDA sources compiled with nvcc (build time, registers);
3. kernels: every point of each emitted space launched at the slice shapes
   (flash also in f32 and at a padded S=2000) and held against the plain
   PyTorch version on the card within the stated tolerance;
4. main path, per kernel: launch counts reset, a cold tune (evaluations >
   0), a fresh op on the same DB file recalling with 0 evaluations and two
   fast-path calls; launches > 0 and plain-version calls unchanged;
   for exb one exhaustive search compared with the staged winner.

The line before the last is ``{"kernels": [...]}``: per kernel its launches
on the main path, max error over the sweep, time at the tuned point, the
plain version's time, the bound (bytes over memory rate or operations over
peak rate, the larger) and the library call's time.  The last line is
``{"ok": true, "device": {...}}``.  The script exits non-zero, and prints
no result, without a CUDA card or without the repository beside it.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# (rtol, atol) per dtype: the JAX package's DEFAULT_TOL (tests/conformance.py)
TOL = {"float32": (2e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}
# Per output row (the last axis: one head's hd values, or one my line of
# exb): error norm over the plain version's norm, worst row.  The element
# check alone is loose for bf16 attention at S=2048, whose outputs are only
# 0.03-0.05, so a kernel that dropped one 64-key block would stay inside
# atol 2e-2.  bf16: four ulps of the output (4 * 2**-8); f32: the rtol.
ROW_TOL = {"float32": 2e-4, "bfloat16": 4 * 2.0**-8}

EXB_DIMS = (16, 16, 128, 65)
# tinyllama-1.1b: 32 query heads, 4 KV heads, head_dim 64
FLASH = dict(B=1, S=2048, H=32, KV=4, hd=64)


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


def max_err(torch, out, ref, dtype: str):
    """(max abs error, worst row error ratio, list of the checks failed)."""
    rtol, atol = TOL[dtype]
    worst, worst_row, failed = 0.0, 0.0, []
    for o, r in zip(out, ref):
        o, r = o.float(), r.float()
        if o.shape != r.shape or not bool(torch.isfinite(o).all()):
            return math.inf, math.inf, ["shape/finite"]
        diff = (o - r).abs()
        worst = max(worst, float(diff.max()))
        if not bool((diff <= atol + rtol * r.abs()).all()):
            failed.append(f"element {TOL[dtype]}")
        row = diff.norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
        worst_row = max(worst_row, float(row.max()))
    if worst_row > ROW_TOL[dtype]:
        failed.append(f"row {ROW_TOL[dtype]}")
    return worst, worst_row, failed


def sweep(torch, label, region, run, plain_out, dtype, timer, counter, errors):
    """Launch every emitted point, compare each with the plain version,
    time each; returns (max error, {pp_key: ms})."""
    from repro_torch.core import pp_key

    before = counter.launches
    worst, worst_row, times = 0.0, 0.0, {}
    points = list(region.space.points())
    for point in points:
        out = run(point)
        torch.cuda.synchronize()
        err, row, failed = max_err(torch, out if isinstance(out, tuple) else (out,),
                                   plain_out, dtype)
        worst, worst_row = max(worst, err), max(worst_row, row)
        if failed:
            errors.append(f"{label} {point}: max abs error {err}, row error {row}; "
                          f"failed {failed}")
        times[pp_key(point)] = timer.ms(lambda: run(point), reps=5)
    if counter.launches - before < len(points):
        errors.append(f"{label}: {counter.launches - before} launches for {len(points)} points")
    best = min(times, key=times.get)
    print(f"[kernel] {label}: {len(points)} candidates, max abs err {worst:.3e} "
          f"(tol {TOL[dtype]}), row error {worst_row:.3e} (tol {ROW_TOL[dtype]}), "
          f"fastest {best} {times[best]:.4f} ms")
    print(f"[sweep] {label}: " + json.dumps(
        {k: round(v, 4) for k, v in sorted(times.items(), key=lambda kv: kv[1])}))
    return worst, worst_row, times


def main_path(torch, name, args, plain_out, dtype, db_path, errors):
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
    err, row, failed = max_err(torch, out if isinstance(out, tuple) else (out,),
                               plain_out, dtype)
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

    from repro_torch.core import ExhaustiveSearch, TuningDB, autotuned, detect, pp_key
    from repro_torch.kernels import _build
    from repro_torch.kernels.exb import exb as exb_mod, ops as exb_ops, ref as exb_ref
    from repro_torch.kernels.flash_attention import (
        flash_attention as fa_mod, ops as fa_ops, ref as fa_ref,
    )

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
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {log.stem}: {line.strip()}")
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
    for dtype_name, dtype, S in (("bfloat16", torch.bfloat16, 2048),
                                 ("float32", torch.float32, 2048),
                                 ("bfloat16", torch.bfloat16, 2000),
                                 ("float32", torch.float32, 2000)):
        shape = dict(FLASH, S=S)
        qkv = fa_ref.make_inputs(gen, dtype=dtype, device=device, **shape)
        plain_out = (fa_mod.attention_plain(*qkv),)
        region = fa_ops.flash_region(S, shape["hd"], dtype_name, arch=arch)
        for point in region.space.points():
            model = fa_mod.smem_bytes(point["block_q"], point["block_kv"],
                                      shape["hd"], qkv[0].element_size())
            native = fa_mod.smem_bytes_native(point["block_q"], point["block_kv"],
                                              shape["hd"], dtype)
            if model != native or model > optin:
                errors.append(f"flash {point}: smem model {model}, kernel {native}, limit {optin}")
        label = f"flash {dtype_name} (1,{S},32|4,64)"
        err, row, times = sweep(
            torch, label, region,
            lambda p, qkv=qkv: fa_mod.flash_attention_cuda(*qkv, **p),
            plain_out, dtype_name, timer, fa_mod.counter, errors,
        )
        fa_err, fa_row = max(fa_err, err), max(fa_row, row)
        flash_cases[(dtype_name, S)] = (qkv, plain_out, times)
    if errors:
        for e in errors:
            print(f"[error] {e}", file=sys.stderr)
        return fail(f"{len(errors)} kernel check(s) failed")

    # -- main path: the registry loop, counts read around it ---------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    db_path = str(Path(tmp) / "tuning_db.json")
    qkv, flash_plain, flash_times = flash_cases[("bfloat16", 2048)]
    for counter in (exb_mod.counter, fa_mod.counter):
        counter.reset()
    exb_state, exb_tune_s, exb_recall_s = main_path(
        torch, "exb", (inp,), exb_plain_out, "float32", db_path, errors)
    fa_state, fa_tune_s, fa_recall_s = main_path(
        torch, "flash_attention", qkv, flash_plain, "bfloat16", db_path, errors)
    launches = {"exb": exb_mod.counter.launches,
                "flash_attention": fa_mod.counter.launches}
    plain_calls = exb_mod.counter.plain_calls + fa_mod.counter.plain_calls
    print(f"[main] launches {launches}, plain-version calls {plain_calls}")
    if min(launches.values()) <= 0 or plain_calls != 0:
        errors.append("main path did not run through both kernels alone")

    # exb: staged winner against one exhaustive search (25 points)
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
    fa_pt = fa_state.region.selected
    fa_best = min(flash_times, key=flash_times.get)
    print(f"[main] flash: staged winner {fa_pt} "
          f"{flash_times[pp_key(fa_pt)]:.4f} ms in the sweep; fastest swept {fa_best} "
          f"{flash_times[fa_best]:.4f} ms")
    if errors:
        for e in errors:
            print(f"[error] {e}", file=sys.stderr)
        return fail(f"{len(errors)} main-path check(s) failed")

    # -- the kernels line --------------------------------------------------
    iv, iz, mx, my = EXB_DIMS
    exb_bytes = 4.0 * (6 * iv * iz * mx * my + 8 * iz * mx * my + iv)
    exb_flops = 24.0 * iv * iz * mx * my
    exb_bound = max(exb_bytes / arch.hbm_bandwidth, exb_flops / arch.peak_flops_fp32)
    B, S, H, KV, hd = (FLASH[k] for k in ("B", "S", "H", "KV", "hd"))
    fa_flops = 4.0 * B * H * S * S * hd / 2  # causal: half the square
    fa_bytes = 2.0 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    fa_bound = max(fa_flops / arch.peak_flops, fa_bytes / arch.hbm_bandwidth)
    q, k, v = qkv
    qt, kt, vt = (t.transpose(1, 2) for t in qkv)
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
            "source": "src/repro_torch/csrc/flash_attention.cu",
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
            "tune_s": fa_tune_s, "recall_s": fa_recall_s,
        },
    ]
    print(json.dumps({"kernels": kernels}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
