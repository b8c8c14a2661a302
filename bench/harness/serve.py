"""The runner of a serving cell (``"kind": "serve"``).

Set-up draws the weights from the seed, tunes (first run) or recalls the
prefill's kernel shape classes through the program's front door (a
``ServingRule`` that tunes inline on the cell's TuningDB, around
``prefill_fn`` at every (group, prompt length) the engine can form), warms
each decode bucket, and builds one ``StreamingEngine`` on that DB (no
background tuner), which serves one short request before the window.  The
window offers the job's batches one ``serve()`` call each, every request
of a batch at once, until ``--seconds`` have passed; the batch running
then completes, and the window ends with it.

After the window the engine and the weights are freed, and the float32
reference (the configuration's reference module's ``logits_at``, found by
name: :mod:`harness.family`), on the same weights drawn again,
reads its logits at every served position of a sample of the completed
requests (the longest among them): the number compared is the widest gap
by which a served token's logit lies below the reference's best.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from . import device as dev
from . import family, traffic, weights
from .outcome import Outcome, free, set_up_phases
from .trace import profiled, reduce, span
from .train import model_config

STAT_KEYS = ("prefill_s", "decode_s", "prefill_steps", "decode_steps", "tokens_out")


def _stats(engine) -> Dict[str, float]:
    return {k: getattr(engine.stats, k) for k in STAT_KEYS}


def warm(torch, cfg, params, db, job: Dict[str, Any], device, max_len: int) -> None:
    """Tune or recall every prefill class the engine can form, and run a
    decode step at every bucket of rows the pool can hold."""
    from repro_torch.models import ServingRule, decode_fn, init_cache, prefill_fn, serving

    rule = ServingRule(db, inline_tune=True)
    gen = torch.Generator(device=device).manual_seed(0)
    for plen in sorted(set(traffic.prompt_lengths(job))):
        for group in job["prefill_groups"]:
            tokens = torch.randint(0, cfg.vocab_size - 1, (group, plen), generator=gen,
                                   device=device, dtype=torch.int32)
            with serving(rule):
                prefill_fn(params, {"tokens": tokens}, cfg, capacity=max_len)
    rows = 1
    while rows <= job["pool_rows"]:
        cache = init_cache(cfg, rows, max_len, device)
        cache["len"] = torch.full((rows,), 1, dtype=torch.int64, device=device)
        toks = torch.zeros((rows, 1), dtype=torch.int32, device=device)
        with serving(rule):
            decode_fn(params, {"tokens": toks}, cache, cfg)
        rows *= 2
    if device.type == "cuda":
        torch.cuda.synchronize()


def requests_of(batch: List[Dict[str, Any]]):
    from repro_torch.data.pipeline import ServingRequest

    return [ServingRequest(rid=r["rid"], prompt=r["prompt"], max_new_tokens=r["answer"])
            for r in batch]


@dataclass
class Prepared:
    """What set-up hands the window: the engine, the weights it serves, the
    largest prompt and answer it is sized for, and when set-up's phases
    ended."""

    cfg: Any
    engine: Any
    params: Any
    max_len: int
    phases: List[Tuple[str, float]]


def setup(cell, seed: int, device: Any, cache_dir, hook: Optional[Callable] = None) -> Prepared:
    """Draw the weights from ``seed``, tune or recall every prefill class and
    warm every decode bucket, and build the engine, which serves one short
    request.  ``hook(engine)``, where given, wraps the engine (a fault
    underneath)."""
    import torch

    from repro_torch.core import TuningDB
    from repro_torch.models.spec import build_params
    from repro_torch.runtime import StreamingEngine

    config, job = cell.config, cell.job
    cfg = model_config(config, job)
    plan = traffic.batch_plan(job)
    max_len = max(p for p, _ in plan) + max(a for _, a in plan)
    cache_dir.mkdir(parents=True, exist_ok=True)
    db = TuningDB(str(cache_dir / "tuning.json"))
    phases = [("program built", time.perf_counter())]
    params = build_params(weights.draw(config, seed, device))
    phases.append(("weights drawn", time.perf_counter()))
    warm(torch, cfg, params, db, job, device, max_len)
    engine = StreamingEngine(cfg, params, n_blocks=job["pool_rows"], max_len=max_len,
                             tuning_db=db)
    engine = hook(engine) if hook is not None else engine
    engine.serve(requests_of([{"rid": -1, "prompt": np.zeros(min(plan)[0], np.int32),
                               "answer": 2}]))
    phases.append(("classes tuned or recalled, shapes warmed, engine built", time.perf_counter()))
    return Prepared(cfg, engine, params, max_len, phases)


def served(engine, batch: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Each request of ``batch`` with the tokens ``engine`` gave it, or
    None where it failed or came short."""
    out = []
    for r in batch:
        res = engine.results.get(r["rid"])
        ok = res is not None and res.status == "ok" and len(res.tokens) == r["answer"]
        out.append(dict(r, tokens=list(res.tokens)) if ok else None)
    return out


def run(cell, seed: int, seconds: float, trace_on: bool, t0: float, device: Any,
        cache_dir, clocks: dev.ClockLog, hook: Optional[Callable] = None) -> Outcome:
    """One run of a serving cell; ``hook`` as :func:`setup` takes it."""
    import torch

    config, job = cell.config, cell.job
    p = setup(cell, seed, device, cache_dir, hook)
    cfg, engine = p.cfg, p.engine
    before = _stats(engine)
    evals_before = engine.hot_path_cost_evaluations

    # the window
    if device.type == "cuda":
        torch.cuda.synchronize()
    clocks.sample("window start")
    done: List[Dict[str, Any]] = []
    attempted = failed = 0
    batch_s: List[float] = []
    with profiled(trace_on) as prof:
        t_start = time.perf_counter()
        with span("bench.window"):
            index = 0
            while True:
                batch = traffic.serve_batch(job, cfg.vocab_size, seed, index)
                t_b = time.perf_counter()
                with span("bench.serve"):
                    engine.serve(requests_of(batch))
                batch_s.append(time.perf_counter() - t_b)
                for r in served(engine, batch):
                    attempted += 1
                    if r is None:
                        failed += 1
                    else:
                        done.append(r)
                index += 1
                if time.perf_counter() - t_start >= seconds:
                    break
            if device.type == "cuda":
                torch.cuda.synchronize()
        window_s = time.perf_counter() - t_start
    clocks.sample("window end")
    setup_s = t_start - t0
    phases = set_up_phases(t0, p.phases, t_start)
    after = _stats(engine)
    delta = {k: after[k] - before[k] for k in STAT_KEYS}
    evals = engine.hot_path_cost_evaluations - evals_before
    peak = dev.peak_bytes(torch, 1) if device.type == "cuda" else 0
    trace = reduce(prof) if prof is not None else None
    del p, engine
    free(torch, device)

    # the reference reads the served positions of a sample
    sample = traffic.sample_for_check(done, seed, job["sample"]["served_tokens"])
    t_ref = time.perf_counter()
    numbers = reference_gaps(torch, config, sample, seed, device)["served"]
    ref_s = time.perf_counter() - t_ref
    n_served = sum(len(r["tokens"]) for r in sample)

    prompt_tokens = sum(len(r["prompt"]) for r in done)
    out_tokens = sum(len(r["tokens"]) for r in done)
    details = [phases,
        f"[serve] {cfg.name}: {index} batches of {job['batch_requests']}, {attempted} requests "
        f"({failed} failed), {prompt_tokens} prompt and {out_tokens} generated tokens in "
        f"{window_s:.3f} s, {(prompt_tokens + out_tokens) / window_s:.1f} tokens/s; set-up "
        f"{setup_s:.3f} s; engine {delta}; evaluations in the window {evals}; batches' seconds "
        f"{[round(b, 3) for b in batch_s]}",
        f"[check] {len(sample)} requests, {n_served} served tokens held to the reference "
        f"({ref_s:.1f} s); numbers {numbers}",
    ]
    return Outcome(
        setup_s=setup_s, window_s=window_s,
        end_to_end={"serve_tokens_per_s": (prompt_tokens + out_tokens) / window_s},
        attempted=attempted, failed=failed + (len(sample) == 0),
        checks={name: (numbers[name], limit) for name, limit in job["checks"].items()},
        memory_peak_bytes=peak,
        counters={"requests": [(len(r["prompt"]), len(r["tokens"])) for r in done],
                  "prompt_tokens": prompt_tokens, "generated_tokens": out_tokens,
                  "serve_s": sum(batch_s), "hot_path_evaluations": evals, **delta},
        trace=trace, config=config, job=job, details=details,
    )


def reference_gaps(torch, config: Dict[str, Any], sample: List[Dict[str, Any]], seed: int,
                   device, control: bool = False) -> Dict[str, Dict[str, float]]:
    """:func:`gap_numbers` of the served tokens against the float32
    reference over every served position of ``sample`` (the reference on
    the weights drawn again from ``seed``); with ``control`` also those of
    the tokens the control puts first at the same positions: the reference
    in 8-bit floats (every product's inputs, and every activation the
    program keeps in bfloat16, in e4m3)."""
    from reference.common import F32, FP8, fp8_kept, full_float32

    full_float32()
    ref = family.reference_of(config)
    ref_w = weights.draw(config, seed, device)
    sizes = family.sizes(config)
    seqs, positions = [], []
    for r in sample:
        ids = np.concatenate([r["prompt"], np.asarray(r["tokens"][:-1], np.int32)])
        seqs.append(torch.from_numpy(ids.astype(np.int64)).to(device))
        plen = len(r["prompt"])
        positions.append(torch.arange(plen - 1, plen - 1 + len(r["tokens"]), device=device))
    logits = ref.logits_at(ref_w, sizes, seqs, positions, F32)
    picks = [torch.tensor(r["tokens"], device=device) for r in sample]
    out = {"served": gap_numbers(logits, picks)}
    if control:
        low = ref.logits_at(ref_w, sizes, seqs, positions, FP8, fp8_kept)
        out["control"] = gap_numbers(logits, [lg.argmax(dim=-1) for lg in low])
    del ref_w, logits
    free(torch, device)
    return out


def gap_numbers(logits, picks) -> Dict[str, float]:
    """Over every position, the gap by which the picked token's logit lies
    below the reference's best: the widest (``widest_gap``), the mean
    (``mean_gap``), and the share of positions where it is not the best
    (``flip_share``)."""
    import torch

    gaps = torch.cat([lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0]
                      for lg, tok in zip(logits, picks)])
    return {"widest_gap": float(gaps.max()), "mean_gap": float(gaps.mean()),
            "flip_share": float((gaps > 0).float().mean())}


def readings(cell, seeds: Iterable[int], control_seeds: Iterable[int], device,
             cache_dir, say: Callable[[str], None] = print) -> List[Dict[str, Any]]:
    """The readings the cell's limits are set from (:mod:`harness.control`):
    on each seed one batch through the engine, then the float32 reference's
    widest gap over a sample of its served tokens, as a run takes it; on
    the control's seeds also that of the tokens the 8-bit reference puts
    first at the same positions."""
    import torch

    config, job = cell.config, cell.job
    control_seeds = set(control_seeds)
    rows = []
    for seed in seeds:
        p = setup(cell, seed, device, cache_dir)
        batch = traffic.serve_batch(job, p.cfg.vocab_size, seed, 0)
        p.engine.serve(requests_of(batch))
        done = [r for r in served(p.engine, batch) if r is not None]
        del p
        free(torch, device)
        sample = traffic.sample_for_check(done, seed, job["sample"]["served_tokens"])
        gaps = reference_gaps(torch, config, sample, seed, device, seed in control_seeds)
        row = {"seed": seed, "requests": len(done), "sampled": len(sample),
               "served_tokens": sum(len(r["tokens"]) for r in sample),
               "program": gaps["served"]}
        if "control" in gaps:
            row["control"] = gaps["control"]
        say(f"[calibrate] {cell.name} {row}")
        rows.append(row)
    return rows
