"""Batched serving with the PyTorch port: prefill + greedy decode on the card.

    python3 examples/torch_serve_lm.py --arch recurrentgemma-2b

Serves a batch of synthetic requests through the port's ``Server`` (per
family cache: KV ring buffers for the hybrid arch, O(1) SSM state for
falcon-mamba), attention and the two recurrences on the hand-written
kernels; the weights are random, drawn from seed 0.  ``--device cpu``
runs the kernels' plain versions on the CPU instead.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import synthetic_requests
from repro_torch.models import init_params
from repro_torch.runtime import Server


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=list(ARCH_IDS))
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--batch-size", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device; pass --device cpu to run on the CPU")

    cfg = get_config(args.arch, smoke=True)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    server = Server(cfg, params, batch_size=args.batch_size,
                    max_len=args.prompt_len + args.new_tokens)

    reqs = synthetic_requests(
        cfg, n=args.requests, prompt_len=args.prompt_len,
        max_new_tokens=args.new_tokens,
    )
    out = server.run(reqs)
    for rid in sorted(out):
        toks = out[rid]
        print(f"req {rid}: {len(toks)} tokens -> {toks[:12]}{'...' if len(toks) > 12 else ''}")
    s = server.stats
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(
        f"\nprefill {s.prefill_s * 1e3:.1f} ms total; decode {s.decode_s * 1e3:.1f} ms; "
        f"{s.decode_tok_per_s:.1f} tok/s ({name}, reduced config)"
    )


if __name__ == "__main__":
    main()
