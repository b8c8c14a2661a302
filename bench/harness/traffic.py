"""The one generator of the benchmark's inputs, driven by a cell's job file.

Training (``"kind": "train"``): each step a batch of ``batch`` rows of
``seq + 1`` token ids, uniform over the vocabulary but its last id, drawn
on the host from (seed, step); tokens are a row's first ``seq`` ids and the
targets its last ``seq``.

Serving (``"kind": "serve"``): offline batches of ``batch_requests``
requests, all offered at once.  Every batch holds the same multiset of
(prompt length, answer length) pairs, for every seed: prompt lengths at
the midpoints of ``batch_requests`` equal steps of the ``prompt`` law's
quantile, rounded to the nearest multiple of ``prompt.multiple``; answer
lengths evenly over ``answer.min``..``answer.max``, paired with the
prompts by a fixed permutation.  The seed orders each batch and draws its
prompts' token ids.  So two seeds do the same work in another order.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np

PAIRING_SEED = 20240601  # fixes which answer length goes with which prompt


def train_rows(job: Dict[str, Any], vocab: int, seed: int, step: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng([int(seed), int(step), 0x7A1])
    rows = rng.integers(0, max(2, vocab - 1), size=(job["batch"], job["seq"] + 1),
                        dtype=np.int64)
    return {"tokens": rows[:, :-1].astype(np.int32), "targets": rows[:, 1:].astype(np.int32)}


def prompt_lengths(job: Dict[str, Any]) -> List[int]:
    p, n = job["prompt"], job["batch_requests"]
    if p["law"] != "log-uniform":
        raise ValueError(f"unknown prompt-length law {p['law']!r}")
    lo, hi, mult = p["min"], p["max"], p["multiple"]
    out = []
    for i in range(n):
        x = lo * (hi / lo) ** ((i + 0.5) / n)
        out.append(int(min(hi, max(lo, mult * round(x / mult)))))
    return out


def answer_lengths(job: Dict[str, Any]) -> List[int]:
    a, n = job["answer"], job["batch_requests"]
    span = a["max"] - a["min"] + 1
    lengths = [a["min"] + int(math.floor((j + 0.5) * span / n)) for j in range(n)]
    order = np.random.default_rng(PAIRING_SEED).permutation(n)
    return [lengths[j] for j in order]


def batch_plan(job: Dict[str, Any]) -> List[Tuple[int, int]]:
    """The (prompt length, answer length) pairs of every batch."""
    return list(zip(prompt_lengths(job), answer_lengths(job)))


def serve_batch(job: Dict[str, Any], vocab: int, seed: int, index: int) -> List[Dict[str, Any]]:
    """Batch ``index``: ``rid``, ``prompt`` (int32 ids) and ``answer`` (tokens
    to generate) of each request, in the seed's order."""
    rng = np.random.default_rng([int(seed), int(index), 0x5E7])
    plan = batch_plan(job)
    out = []
    for k, i in enumerate(rng.permutation(len(plan))):
        plen, alen = plan[i]
        prompt = rng.integers(0, max(2, vocab - 1), size=plen, dtype=np.int64).astype(np.int32)
        out.append({"rid": index * 100_000 + k, "prompt": prompt, "answer": alen})
    return out


def sample_for_check(done: List[Dict[str, Any]], seed: int, served_tokens: int) -> List[Dict]:
    """Requests to hold against the reference: the longest (prompt and
    answer) first, then others in an order drawn from the seed, until
    ``served_tokens`` served tokens are in the sample."""
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: (len(done[i]["prompt"]) + done[i]["answer"],
                                                   -i))
    rest = [i for i in np.random.default_rng([int(seed), 0xC4EC]).permutation(len(done))
            if i != longest]
    picked, count = [], 0
    for i in [longest] + rest:
        if count >= served_tokens:
            break
        picked.append(done[i])
        count += len(done[i]["tokens"])
    return picked
