"""npz + JSON checkpoints in the reference's format."""
