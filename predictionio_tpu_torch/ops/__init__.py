"""Scoring ops and the hand-written CUDA kernel they launch."""
