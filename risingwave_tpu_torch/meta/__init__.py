"""The barrier/checkpoint loop."""
