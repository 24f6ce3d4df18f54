"""The deep-net training layer: train-step factories for allreduce DP and
the consensus strategies (`steps.py`)."""
