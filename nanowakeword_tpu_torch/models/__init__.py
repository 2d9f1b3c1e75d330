"""The speech encoder and the classifier backbones."""
