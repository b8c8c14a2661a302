"""Plain float32 PyTorch references of the benchmark's configurations.

They import nothing of the program (``repro_torch``) and take nothing it
made: the harness hands them the weights it drew from the seed (drawn
again for them) and the inputs it generated, and they work out the rest
(logits, losses, gradients, optimizer state) themselves.  On the card
float32 products run with TF32 off (:func:`common.full_float32`).

Each takes a matrix product ``mm`` (:data:`common.F32`, or the control's
:data:`common.FP8`, the precision below the configurations' bfloat16).
"""
