"""Signal-processing ops: the log-mel frontend and its CUDA kernel."""
