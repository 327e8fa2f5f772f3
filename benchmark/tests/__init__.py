"""The benchmark's CPU tests."""
