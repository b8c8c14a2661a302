"""The port's train step against the JAX package's for the
encoder-decoder family (whisper-large-v3 SMOKE), whose JAX reference runs
op by op (~30 s): apart from the other families'
(``test_torch_train_step``), so the two files run on separate workers.
Tolerances as that module states for Whisper."""
from __future__ import annotations

from test_torch_train_step import check_train_step_matches_jax


def test_train_step_matches_jax_encdec():
    check_train_step_matches_jax("whisper-large-v3")
