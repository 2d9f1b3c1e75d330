"""Helpers that need no accelerator."""
