"""The feature frontend."""
