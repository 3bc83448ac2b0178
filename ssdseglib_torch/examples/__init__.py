"""Runnable examples of the port: ``python -m ssdseglib_torch.examples.<name>``."""
