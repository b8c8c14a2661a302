"""Deterministic synthetic data: the training stream and serving traffic.

``repro.data.pipeline`` copied: numpy only, so one seed gives the same
batches (tokens, targets, loss masks, the VLM's positions and vision
embeddings, the encoder-decoder's frames), prompts, lengths, arrivals,
deadlines and priorities in both packages.

Fault-tolerance contract of the training stream: ``batch(step)`` is a pure
function of ``(seed, step, topology)``, so a restarted job replays the
exact token stream from its restored step with no data-loader state to
checkpoint.  Its "documents" are runs of tokens from a narrow vocabulary
band with an EOS separator, so the stream has structure an optimizer can
learn (a uniform stream would hide optimizer faults).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..models.config import ModelConfig


class SyntheticLMDataset:
    def __init__(
        self,
        cfg: ModelConfig,
        global_batch: int,
        seq_len: int,
        seed: int = 0,
        doc_len: int = 128,
    ) -> None:
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed
        self.doc_len = doc_len

    def batch(
        self, step: int, host_id: int = 0, n_hosts: int = 1
    ) -> Dict[str, np.ndarray]:
        """The (host-sharded) batch for ``step``.  Pure in (seed, step)."""
        if self.global_batch % n_hosts:
            raise ValueError("global_batch must divide n_hosts")
        local = self.global_batch // n_hosts
        rows = []
        for r in range(local):
            global_row = host_id * local + r
            rows.append(self._row(step, global_row))
        tokens = np.stack(rows)  # (local, seq+1)
        out: Dict[str, np.ndarray] = {
            "tokens": tokens[:, :-1].astype(np.int32),
            "targets": tokens[:, 1:].astype(np.int32),
            "loss_mask": np.ones((local, self.seq_len), np.float32),
        }
        cfgm = self.cfg
        if cfgm.family == "vlm":
            rng = self._rng(step, 1_000_003)
            out["vision_embeds"] = rng.standard_normal(
                (local, cfgm.n_vision_tokens, cfgm.d_model), dtype=np.float32
            )
            pos = np.broadcast_to(
                np.arange(self.seq_len, dtype=np.int32), (local, self.seq_len)
            )
            out["positions"] = np.broadcast_to(pos, (3, local, self.seq_len)).copy()
            out["loss_mask"][:, : cfgm.n_vision_tokens] = 0.0
        if cfgm.is_encoder_decoder:
            rng = self._rng(step, 2_000_003)
            out["frames"] = rng.standard_normal(
                (local, cfgm.encoder_len, cfgm.d_model), dtype=np.float32
            ).astype(np.float32)
        return out

    # -- internals -------------------------------------------------------------

    def _rng(self, step: int, salt: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, salt])
        )

    def _row(self, step: int, row: int) -> np.ndarray:
        """One (seq_len+1)-token row built from synthetic documents."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, row]))
        V = self.cfg.vocab_size
        eos = V - 1
        toks: List[int] = []
        need = self.seq_len + 1
        while len(toks) < need:
            # each document draws from a narrow vocab band -> learnable bigrams
            base = int(rng.integers(0, max(1, V - 64)))
            width = int(rng.integers(8, 64))
            ln = int(rng.integers(self.doc_len // 2, self.doc_len))
            walk = rng.integers(0, width, size=ln)
            toks.extend((base + np.cumsum(walk) % width).tolist())
            toks.append(eos)
        return np.asarray(toks[:need], dtype=np.int64)


# ---------------------------------------------------------------------------
# Serving-side synthetic requests
# ---------------------------------------------------------------------------


@dataclass
class ServingRequest:
    rid: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int
    # open-loop arrival offset in (virtual) seconds since trace start; 0 for
    # the closed-loop traces, so every pre-stream consumer is unaffected.
    arrival_s: float = 0.0
    # absolute virtual-clock deadline: past it the hardened engine retires
    # the request ``timed_out`` instead of serving it.  None = no deadline
    # (the engine-level default TTL, if any, applies).
    deadline_s: Optional[float] = None
    # admission priority: higher admits first, and a strictly higher waiting
    # priority may preempt a lower in-flight one when the KV pool is
    # exhausted.  0 (the default) reproduces pre-hardening scheduling.
    priority: int = 0


def synthetic_requests(
    cfg: ModelConfig,
    n: int,
    prompt_len: int,
    max_new_tokens: int,
    seed: int = 0,
) -> List[ServingRequest]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = rng.integers(0, cfg.vocab_size - 1, size=prompt_len).astype(np.int32)
        out.append(ServingRequest(rid=i, prompt=p, max_new_tokens=max_new_tokens))
    return out


# (profile name, prompt-length range, new-token range): a prefill-heavy mode
# (long prompt, short completion), a decode-heavy mode (short prompt, long
# completion), and a balanced middle — the mix a real endpoint sees, and the
# load shape the traffic-class tuner (docs/serving.md) buckets.
_TRACE_MODES = (
    ("prefill_heavy", (48, 96), (2, 6)),
    ("decode_heavy", (4, 12), (16, 48)),
    ("balanced", (16, 32), (8, 16)),
)


def mixed_traffic_trace(
    cfg: ModelConfig,
    n: int,
    seed: int = 0,
    scale: float = 1.0,
) -> List[ServingRequest]:
    """A deterministic mixed prefill/decode request trace.

    Interleaves prefill-heavy, decode-heavy, and balanced requests so a
    server sees several distinct traffic classes in one pass.  ``scale``
    multiplies all lengths (e.g. 0.25 for fast CI smoke runs).
    """
    rng = np.random.default_rng(seed)
    out: List[ServingRequest] = []
    for i in range(n):
        _, (p_lo, p_hi), (t_lo, t_hi) = _TRACE_MODES[
            int(rng.integers(0, len(_TRACE_MODES)))
        ]
        plen = max(1, int(rng.integers(p_lo, p_hi + 1) * scale))
        if cfg.family == "vlm":
            # vision embeds replace the first n_vision_tokens slots of the
            # prompt; shorter prompts would be all-vision (degenerate)
            plen = max(plen, cfg.n_vision_tokens + 1)
        new = max(1, int(rng.integers(t_lo, t_hi + 1) * scale))
        prompt = rng.integers(0, cfg.vocab_size - 1, size=plen).astype(np.int32)
        out.append(ServingRequest(rid=i, prompt=prompt, max_new_tokens=new))
    return out


def bursty_open_loop_trace(
    cfg: ModelConfig,
    n: int,
    seed: int = 0,
    scale: float = 1.0,
    burst_size: int = 4,
    burst_gap_s: float = 0.05,
    jitter_s: float = 0.005,
) -> List[ServingRequest]:
    """An open-loop arrival trace: bursts of requests separated by quiet gaps.

    The request mix is exactly :func:`mixed_traffic_trace` (same seed, same
    prompts and lengths) with arrival timestamps layered on top: requests
    land in bursts of ``burst_size`` (all members of a burst arrive within
    ``jitter_s`` of the burst start), and consecutive bursts are
    ``burst_gap_s`` apart.  Open loop means arrivals do not wait for the
    server — a slow scheduler sees the queue build up, which is what the
    time-to-first-token percentiles in bench_serve_stream measure.

    Fully deterministic in ``(seed, n, scale, burst_size, burst_gap_s,
    jitter_s)``: replayable across processes for tuning and benchmarking.
    """
    if burst_size < 1:
        raise ValueError(f"burst_size must be >= 1, got {burst_size}")
    reqs = mixed_traffic_trace(cfg, n, seed=seed, scale=scale)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xB125_7]))
    for i, r in enumerate(reqs):
        burst = i // burst_size
        r.arrival_s = burst * burst_gap_s + float(rng.uniform(0.0, jitter_s))
    # within-burst jitter may reorder neighbours; keep the list sorted by
    # arrival so replay loops can admit with a simple cursor
    reqs.sort(key=lambda r: (r.arrival_s, r.rid))
    return reqs


def adversarial_trace(
    cfg: ModelConfig,
    n: int,
    seed: int = 0,
    scale: float = 1.0,
    burst_size: int = 4,
    burst_gap_s: float = 0.05,
    deadline_fraction: float = 0.5,
    deadline_ttl_s: float = 0.5,
    priority_levels: int = 3,
    malformed_rate: float = 0.0,
    max_len_hint: int = 0,
) -> List[ServingRequest]:
    """The overload/chaos trace: :func:`bursty_open_loop_trace` made hostile.

    Layers, from a separate seeded RNG (so the prompt/length mix stays
    byte-identical to the bursty trace at the same ``(seed, n, scale)``):

    * **deadlines** — a ``deadline_fraction`` subset gets an absolute
      deadline ``arrival_s + deadline_ttl_s`` (tight enough to miss under
      queueing, generous enough to make under light load);
    * **priorities** — uniform over ``[0, priority_levels)``, so the
      hardened engine's priority admission and KV-block preemption paths
      actually fire;
    * **malformed requests** — at ``malformed_rate``, a request is replaced
      by one of the malformed variants the hardened engine must absorb
      (empty prompt; ``max_new_tokens`` 0; prompt longer than the engine
      capacity ``max_len_hint`` when given): per-request validation retires
      them with ``error`` status, the un-hardened engine raises.

    Deterministic in all arguments; sorted by ``(arrival_s, rid)`` like
    every open-loop trace.
    """
    if not (0.0 <= deadline_fraction <= 1.0):
        raise ValueError(f"deadline_fraction must be in [0, 1], got {deadline_fraction}")
    if not (0.0 <= malformed_rate <= 1.0):
        raise ValueError(f"malformed_rate must be in [0, 1], got {malformed_rate}")
    if priority_levels < 1:
        raise ValueError(f"priority_levels must be >= 1, got {priority_levels}")
    reqs = bursty_open_loop_trace(
        cfg, n, seed=seed, scale=scale,
        burst_size=burst_size, burst_gap_s=burst_gap_s,
    )
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xAD5E_5]))
    for r in reqs:
        if deadline_fraction and rng.random() < deadline_fraction:
            r.deadline_s = r.arrival_s + deadline_ttl_s
        r.priority = int(rng.integers(0, priority_levels))
        if malformed_rate and rng.random() < malformed_rate:
            kind = int(rng.integers(0, 3 if max_len_hint else 2))
            if kind == 0:
                r.prompt = np.zeros((0,), dtype=np.int32)
            elif kind == 1:
                r.max_new_tokens = 0
            else:
                overlong = max_len_hint + 8
                r.prompt = rng.integers(
                    0, cfg.vocab_size - 1, size=overlong
                ).astype(np.int32)
    return reqs
