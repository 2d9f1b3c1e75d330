"""The `.nww` artifact reader."""
