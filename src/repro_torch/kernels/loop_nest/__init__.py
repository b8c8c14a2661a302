"""The paper's loop-exchange variants on the card: one walker kernel over
launch shapes, with the GKV and Seism3D bodies."""
