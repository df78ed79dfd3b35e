"""Training of the port: AdamW, the causal LM step and checkpoints in the
JAX package's file format."""
