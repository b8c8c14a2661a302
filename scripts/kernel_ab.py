#!/usr/bin/env python3
"""Compare versions of the port's kernels on one CUDA card.

    python3 scripts/kernel_ab.py <src dir> <label> [flash_attention|flash_attention_f32|
                                                     flash_attention_bwd|exb|ssm_scan|
                                                     rglru_scan ...]

Builds the ``repro_torch`` package under ``<src dir>`` (a copy of ``src/``
whose ``csrc/*.cu`` may differ) into ``build/ab_<label>/``, prints each
named kernel's instantiations with their registers and spills, then runs
``chip_smoke.py``'s sweep over every point of the kernel's emitted space
at its A/B shapes: each point held against the plain version (the
tolerances of ``chip_smoke.py``) and timed with its timer (L2 flushed,
median of 5).

* ``flash_attention``: bf16 at tinyllama-1.1b width (B=1 and B=4, S=2048,
  32|4 heads, hd 64), with SDPA's time beside it, and at qwen3-0.6b width
  (B=1, S=2048, 16|8 heads, hd 128);
* ``flash_attention_f32``: f32 at tinyllama-1.1b width (B=1, S=2048 and
  S=2000), with the time of SDPA's memory-efficient kernel in f32 (K and V
  expanded to the query heads) beside it;
* ``flash_attention_bwd``: the bf16 backward at tinyllama-1.1b width (B=1
  and B=4, S=4096, 32|4 heads, hd 64) and qwen3-0.6b width (B=1, S=2048,
  16|8 heads, hd 128) on the forward kernel's o and lse, held against the
  plain version in float32 a batch row at a time, with SDPA's backward
  (its forward and backward less its forward) beside each;
* ``exb``: the paper's GKV domain (16, 16, 128, 65), f32;
* ``ssm_scan``: falcon-mamba-7b width (B=1, S=2048, D=8192, N=16), f32 and
  bf16;
* ``rglru_scan``: recurrentgemma-2b width (B=1, S=2048, W=2560), f32 and
  bf16.

With no kernel named, all of them.  Run it once per version in one call on
the card, in turns (A, B, B, A), and compare only within that call.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KERNELS = ("flash_attention", "flash_attention_f32", "flash_attention_bwd", "exb", "ssm_scan",
           "rglru_scan")
# the sources whose ptxas report a kernel's run prints (those the version has)
SOURCES = {"flash_attention": ("flash_attention_sm90",),
           "flash_attention_f32": ("flash_attention",),
           "flash_attention_bwd": ("flash_attention_bwd_sm90", "flash_attention_bwd"),
           "exb": ("exb",), "ssm_scan": ("ssm_scan",), "rglru_scan": ("rglru_scan",)}


def cases(torch, name, arch, gen, dev):
    """(label, region, run, plain out, dtype, tolerance, counter, library
    call or None) per shape; a library pair (a, b) is timed as a less b."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from chip_smoke import (
        EXB_DIMS, FLASH, FLASH_B, FLASH_BWD, FLASH_HD128, RGLRU, SCAN_TOL, SSM, by_batch_row,
        bwd_rows,
    )
    from repro_torch.core import bucket_pow2

    if name == "flash_attention_bwd":
        from repro_torch.kernels.flash_attention import flash_attention as fa, ops, ref

        for shape in (FLASH_BWD, dict(FLASH_BWD, B=4), FLASH_HD128):
            B, S, H, KV, hd = (shape[k] for k in ("B", "S", "H", "KV", "hd"))
            q, k, v = ref.make_inputs(gen, device=dev, **shape)
            do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
            o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
            args = (q, k, v, o, lse, do)
            plain = bwd_rows(by_batch_row(torch, ref.attention_bwd_plain,
                                          tuple(t.float() for t in args)))
            region = ops.flash_bwd_region(S, hd, "bfloat16", arch=arch,
                                          heads=bucket_pow2(B * H), group=H // KV)
            qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            dot = do.transpose(1, 2).contiguous()

            def sdpa(qt=qt, kt=kt, vt=vt):
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=True)

            library = (lambda sdpa=sdpa, qt=qt, kt=kt, vt=vt, dot=dot: torch.autograd.grad(
                sdpa(), (qt, kt, vt), dot), sdpa)
            yield (f"flash_bwd bfloat16 ({B},{S},{H}|{KV},{hd})", region,
                   lambda p, args=args: bwd_rows(fa.flash_attention_bwd_cuda(*args, **p)),
                   plain, "bfloat16", None, fa.bwd_counter, library)
        return
    if name.startswith("flash_attention"):
        from repro_torch.kernels.flash_attention import flash_attention as fa, ops, ref

        if name == "flash_attention":
            shapes, dt_name = (FLASH, dict(FLASH, B=FLASH_B), FLASH_HD128), "bfloat16"
        else:
            shapes, dt_name = (FLASH, dict(FLASH, S=2000)), "float32"
        for shape in shapes:
            qkv = ref.make_inputs(gen, dtype=getattr(torch, dt_name), device=dev, **shape)
            region = ops.flash_region(shape["S"], shape["hd"], dt_name, arch=arch,
                                      heads=bucket_pow2(shape["B"] * shape["H"]))
            label = (f"flash {dt_name} ({shape['B']},{shape['S']},{shape['H']}|{shape['KV']},"
                     f"{shape['hd']})")
            q, k, v = (t.transpose(1, 2) for t in qkv)
            if dt_name == "bfloat16":
                library = None if shape["hd"] != 64 else (
                    lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True))
            else:
                rep = shape["H"] // shape["KV"]
                k, v = (t.repeat_interleave(rep, dim=1) for t in (k, v))

                def library(q=q, k=k, v=v):
                    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                        return F.scaled_dot_product_attention(q, k, v, is_causal=True)
            yield (label, region, lambda p, qkv=qkv: fa.flash_attention_cuda(*qkv, **p),
                   (fa.attention_plain(*qkv),), dt_name, None, fa.counter, library)
        return
    if name == "exb":
        from repro_torch.kernels.exb import exb as mod, ops, ref

        inp = ref.make_inputs(gen, dims=EXB_DIMS, device=dev)
        yield ("exb f32 (16,16,128,65)", ops.exb_region(dims=EXB_DIMS, arch=arch),
               lambda p: mod.exb_cuda(inp, **p), mod.exb_plain(inp), "float32", None,
               mod.counter, None)
        return
    if name == "ssm_scan":
        from repro_torch.kernels.ssm_scan import ops, ref, ssm_scan as mod

        x, dt, A, Bc, Cc, D = ref.make_inputs(gen, device=dev, **SSM)
        cast = lambda t: (t[0], t[1], A, t[2], t[3], D)  # noqa: E731
        f32 = (x, dt, Bc, Cc)
        region_of = lambda dt_name: ops.ssm_region(  # noqa: E731
            SSM["D"], SSM["S"], SSM["N"], SSM["B"], arch=arch, dtype=dt_name)
        kernel, plain, shape = mod.ssm_scan_cuda, mod.ssm_scan_plain, "(1,2048,8192,N=16)"
    else:
        from repro_torch.kernels.rglru_scan import ops, ref, rglru_scan as mod

        x, r, i, lam = ref.make_inputs(gen, device=dev, **RGLRU)
        cast = lambda t: (*t, lam)  # noqa: E731
        f32 = (x, r, i)
        region_of = lambda dt_name: ops.rglru_region(  # noqa: E731
            RGLRU["W"], RGLRU["S"], RGLRU["B"], arch=arch, dtype=dt_name)
        kernel, plain, shape = mod.rglru_scan_cuda, mod.rglru_scan_plain, "(1,2048,2560)"
    for dt_name, dtype, tol in (("float32", torch.float32, SCAN_TOL),
                                ("bfloat16", torch.bfloat16, None)):
        args = cast(tuple(t.to(dtype) for t in f32))
        yield (f"{name} {dt_name} {shape}", region_of(dt_name),
               lambda p, args=args: kernel(*args, **p), (plain(*args),), dt_name, tol,
               mod.counter, None)


def l2_states(torch, label, run, times, timer, arch, dev) -> None:
    """The fastest swept point timed as the tuner times it (the L2 flushed
    by zeroing twice its size, so it starts full of dirty lines), after a
    flush that reads twice its size (clean lines), and warm (no flush)."""
    import json

    from repro_torch.core.cost import _timed

    point = json.loads(min(times, key=times.get))
    scratch = torch.empty(2 * arch.l2_bytes // 4, dtype=torch.int32, device=dev)
    cycles = int(2e-4 * torch.cuda.get_device_properties(dev).clock_rate * 1e3)

    def clean() -> None:
        scratch.sum()
        torch.cuda._sleep(cycles)

    def median(prepare) -> float:
        run(point)
        torch.cuda.synchronize()
        ms = sorted(_timed(lambda: run(point), prepare) for _ in range(10))
        return ms[len(ms) // 2] * 1e3

    warm = median(lambda: torch.cuda._sleep(cycles))
    print(f"{label} L2 at {point}: dirty {timer.ms(lambda: run(point)):.4f} ms, "
          f"clean {median(clean):.4f} ms, warm {warm:.4f} ms")


def main(src: str, label: str, names) -> int:
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / f"ab_{label}")
    sys.path[:0] = [str(Path(src).resolve()), str(ROOT)]
    import torch

    from chip_smoke import Timer, card_line, ptxas_entries, sweep
    from repro_torch.core import detect
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    print(card_line())
    dev = torch.device("cuda")
    arch = detect(dev)
    t0 = time.perf_counter()
    built = _build.sources()
    for source in built:
        _build.library(source)
    print(f"{label} build {time.perf_counter() - t0:.1f} s")
    for name in names:
        for source in (s for s in SOURCES[name] if s in built):
            log = (_build.build_dir() / _build._digest() / f"{source}.log").read_text()
            for entry, (regs, spill) in sorted(ptxas_entries(log).items()):
                print(f"{label} [ptxas] {entry}: {regs} registers, {spill} B spilled")
    timer = Timer(torch, dev, arch.l2_bytes)
    gen = torch.Generator(device=dev).manual_seed(0)
    errors: list = []
    for name in names:
        for case_label, region, run, plain_out, dtype, tol, counter, library in cases(
                torch, name, arch, gen, dev):
            times = sweep(torch, f"{label} {case_label}", region, run, plain_out, dtype,
                          timer, counter, errors, tol=tol)[2]
            if isinstance(library, tuple):
                ms = timer.ms(library[0]) - timer.ms(library[1])
                print(f"{label} {case_label} sdpa {ms:.4f} ms")
            elif library is not None:
                print(f"{label} {case_label} sdpa {timer.ms(library):.4f} ms")
            l2_states(torch, f"{label} {case_label}", run, times, timer, arch, dev)
    for e in errors:
        print(f"{label} WRONG {e}")
    print(f"{label} points off the plain version: {len(errors)}")
    return 1 if errors else 0


if __name__ == "__main__":
    if len(sys.argv) < 3 or any(n not in KERNELS for n in sys.argv[3:]):
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2], sys.argv[3:] or list(KERNELS)))
