"""Examples of the port: the counterparts of the repository's `examples/`
scripts, each run as `python -m nanowakeword_tpu_torch.examples.<name>`."""
