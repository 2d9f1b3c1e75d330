"""Model evaluators of the port: the counterparts of the repository's
`test_model/` scripts, each run as `python -m
nanowakeword_tpu_torch.test_model.<name>`."""
