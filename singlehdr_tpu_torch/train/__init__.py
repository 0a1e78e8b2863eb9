"""Training: state, steps, checkpoints, metrics and the HDR-Synth loop."""
