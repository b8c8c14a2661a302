"""Quickstart on the card: call a hand-written CUDA kernel through the
port's autotuned-op registry.

    python examples/torch_quickstart.py

One call to ``autotuned("flash_attention")`` runs the whole loop: shape
class → TuningDB lookup → (on a miss) a candidate space emitted from the
card's ArchSpec → staged search timed on the card → dispatch.  The DB
persists to disk, so the second run of this script makes zero cost
evaluations.
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.core import TuningDB, autotuned
from repro_torch.kernels.flash_attention.ref import attention_ref, make_inputs

DB_PATH = os.path.join(tempfile.gettempdir(), "torch_quickstart_registry_db.json")

if not torch.cuda.is_available():
    sys.exit("torch_quickstart: needs a CUDA card")

# 1. Inputs: a causal GQA attention call (B, S, H, hd), f32, on the card.
gen = torch.Generator(device="cuda").manual_seed(0)
q, k, v = make_inputs(gen, B=1, S=1024, H=8, KV=2, hd=64, dtype=torch.float32)

# 2. The registry front door: look up / tune / dispatch in one call.
op = autotuned("flash_attention", db=TuningDB(DB_PATH))
out = op(q, k, v)

state = op.resolve(q, k, v)
print(f"{torch.cuda.get_device_name(0)}")
print(f"shape class: {state.bp}")
print(f"candidates:  {state.region.space.size()} "
      f"(cost evaluations this run: {state.cost_evaluations})")
print(f"selected:    {state.region.selected}  (db={DB_PATH})")

# 3. Verified against the plain version (float32 tolerance).
torch.testing.assert_close(out, attention_ref(q, k, v), rtol=2e-4, atol=1e-5)
print("autotuned kernel output verified against the plain version")

# 4. Re-run this script: the DB hit makes tuning free (cost_evaluations=0).
