"""The streaming interpreter."""
